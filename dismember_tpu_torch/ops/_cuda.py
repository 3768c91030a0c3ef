"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, never at import, into ``build/kernels/`` beside the package; the
library's name carries a hash of the sources and flags, so an unchanged tree
reuses it.  ``nvcc``'s ``-Xptxas=-v`` report (registers, shared memory,
spills per kernel) is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        f"{_PKG / 'csrc'} at first use and need the CUDA toolkit"
    )


def library_path() -> Path:
    """Path of the built library, building it if the sources changed."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libdismember_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(library_path()))
    lib.din_score_f32.argtypes = [_PTR] * 10 + [_INT] * 4 + [_PTR]
    lib.din_score_f32.restype = _INT
    lib.din_score_scratch_floats.argtypes = [_INT]
    lib.din_score_scratch_floats.restype = _INT
    lib.packed_level_bf16.argtypes = [_PTR] * 11 + [_INT] * 5 + [_PTR]
    lib.packed_level_bf16.restype = _INT
    lib.packed_level_bf16_bf16rows.argtypes = [_PTR] * 11 + [_INT] * 5 + [_PTR]
    lib.packed_level_bf16_bf16rows.restype = _INT
    for fn in (lib.write_rows_f32, lib.add_rows_f32, lib.add_rows_bf16):
        fn.argtypes = [_PTR] * 3 + [_I64, _INT, _INT, _PTR]
        fn.restype = _INT
    lib.dr_block_rerank_topk.argtypes = ([_PTR, _PTR, _I64, _PTR, _I64] + [_PTR] * 4 + [_INT] * 9
                                         + [_PTR])
    lib.dr_block_rerank_topk.restype = _INT
    lib.dismember_error_string.argtypes = [_INT]
    lib.dismember_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().dismember_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def check_inputs(name: str, device: torch.device, dtype: torch.dtype = torch.float32,
                 **tensors: torch.Tensor) -> None:
    """Every kernel input is contiguous ``dtype`` on ``device``, 16-byte
    aligned."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def check_shape(name: str, arg: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {shape}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _din_scratch_floats(e: int) -> int:
    return library().din_score_scratch_floats(e)


def din_scratch(e: int, device: torch.device) -> torch.Tensor | None:
    """K1's scratch at width ``e`` on ``device``, allocated on the current
    stream: the prologue's packed weights (``[w1[:, :E] | M]^T``, b1, w2,
    b2) of the wide kernel at E >= 32 (at E = 32 it runs where U <= L or
    L > 10),
    which the kernel writes and reads within one call; None at E = 8 and
    16, which need none."""
    n = _din_scratch_floats(e)
    if n < 0:
        raise ValueError(f"din_score: E={e} is not a built width")
    return torch.empty(n, dtype=torch.float32, device=device) if n else None
