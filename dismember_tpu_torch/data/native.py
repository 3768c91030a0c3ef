"""ctypes bindings of the port's two native host libraries.

``csrc/host_ops.cc`` (:func:`get_lib`) is the port's copy of the JAX
package's ``native/host_ops.cc``, with the same functions and contracts as
``dismember_tpu/data/native.py``: CSV ingest, per-user grouping, the KV
scan, the tree codec, DR's greedy select and the co-occurrence pass.
``csrc/serve_ops.cc`` (:func:`get_serve_lib`) is the port's own: the
serving facade's consumed filter and final top-k.

Each library is compiled by the host compiler (``$CXX``, else ``g++``) at
first use, never at import, into ``build/host/`` beside the package; its
name carries a hash of its source, the flags and the compiler (its
``--version`` and what ``-march=native`` resolves to on this host), so a
host with another CPU or compiler builds its own.  A build goes to a
pid-suffixed file that is then renamed, so processes building at once do
not race.

Every caller falls back to its Python or numpy form when a library is
unavailable: the compiler failed (its stderr is logged once a library at
WARNING) or ``DISMEMBER_NO_NATIVE`` is set (read on every :func:`get_lib`
and :func:`get_serve_lib` call).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("dismember_tpu_torch.native")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_ops.cc"
SERVE_SOURCE = _PKG / "csrc" / "serve_ops.cc"
BUILD_DIR = _PKG.parent / "build" / "host"
# native/Makefile's flags: -ffp-contract=off keeps the greedy select's and
# the co-occurrence pass's arithmetic that of the numpy forms (no fused
# multiply-adds), so their results match bit for bit
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-pthread",
             "-ffp-contract=off", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
_serve_lib = None
_serve_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)


class _CsvResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("users", _I64P),
        ("items", _I64P),
        ("timestamps", _I64P),
        ("labels", _F32P),
        ("categories", ctypes.POINTER(ctypes.c_int32)),
        ("category_names", ctypes.c_char_p),
        ("category_names_len", ctypes.c_int64),
    ]


class _InteractionsResult(ctypes.Structure):
    _fields_ = [
        ("n_users", ctypes.c_int64),
        ("n_items_total", ctypes.c_int64),
        ("unique_users", _I64P),
        ("offsets", _I64P),
        ("items_concat", _I64P),
    ]


class _TreeDecodeResult(ctypes.Structure):
    _fields_ = [
        ("max_level", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
        ("n_pairs", ctypes.c_int64),
        ("node_codes", _I64P),
        ("node_ids", _I64P),
        ("node_probs", _F32P),
        ("node_is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("pair_ids", _I64P),
        ("pair_codes", _I64P),
    ]


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def library_path(source: Path = SOURCE, name: str = "host") -> Path:
    """Path of the library ``libdismember_<name>_<hash>.so`` built from
    ``source``, building it if the source, flags or compiler changed;
    raises ``OSError`` or ``RuntimeError`` when the compiler is missing or
    fails."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(source.read_bytes())
    h.update(_run([cxx, "--version"]).stdout.encode())
    h.update(_run([cxx, "-march=native", "-Q", "--help=target"]).stdout.encode())
    out = BUILD_DIR / f"libdismember_{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = _run(cmd)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dm_parse_csv.restype = ctypes.POINTER(_CsvResult)
    lib.dm_parse_csv.argtypes = [ctypes.c_char_p]
    lib.dm_free_csv.restype = None
    lib.dm_free_csv.argtypes = [ctypes.POINTER(_CsvResult)]
    lib.dm_user_interactions.restype = ctypes.POINTER(_InteractionsResult)
    lib.dm_user_interactions.argtypes = [_I64P, _I64P, _I64P, ctypes.c_int64]
    lib.dm_free_interactions.restype = None
    lib.dm_free_interactions.argtypes = [ctypes.POINTER(_InteractionsResult)]
    lib.dm_scan_kv_records.restype = ctypes.c_int64
    lib.dm_scan_kv_records.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I64P, _I64P,
                                       ctypes.c_int64]
    lib.dm_write_tree.restype = ctypes.c_int64
    lib.dm_write_tree.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, _I64P, _I64P, _F32P,  # leaves
        ctypes.c_int64, _I64P, _I64P, _F32P,  # ancestors
        ctypes.c_int32,  # max_level
    ]
    lib.dm_read_tree.restype = ctypes.POINTER(_TreeDecodeResult)
    lib.dm_read_tree.argtypes = [ctypes.c_char_p]
    lib.dm_free_tree.restype = None
    lib.dm_free_tree.argtypes = [ctypes.POINTER(_TreeDecodeResult)]
    lib.dm_dr_greedy_select.restype = None
    lib.dm_dr_greedy_select.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P,  # cand_idx [n_rows, n_cand]
        _F64P,  # cand_scores
        _I64P,  # occ_rows
        _I64P,  # path_size (in/out)
        _I64P,  # sel_idx (in/out)
        ctypes.c_double, ctypes.c_double,
    ]
    lib.dm_cooc_apply.restype = None
    lib.dm_cooc_apply.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P,  # starts [n_seg]
        _I64P,  # segs [n_seg]
        ctypes.c_int64,
        _I64P,  # src [n_edges]
        _F32P,  # wn [n_edges]
        _F32P,  # f [n_items, dim]
        _F32P,  # g [n_items, dim] (out)
    ]
    return lib


def _bind_serve(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dm_filter_topk.restype = None
    lib.dm_filter_topk.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # b, w, k
        _I64P,  # item_ids [b, w]
        _F32P,  # scores [b, w]
        _I64P,  # consumed ids, the rows' lists one after another
        _I64P,  # consumed lengths [b]
        _I64P,  # out [b, k]
        _I64P,  # counts [b]
    ]
    return lib


def _load(source: Path, name: str, bind, what: str):
    """The bound library built from ``source``, or None (one warning)."""
    try:
        return bind(ctypes.CDLL(str(library_path(source, name))))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.warning("%s unavailable, taking the Python forms: %s", what, e)
        return None


def get_lib():
    """The loaded host library (built on first call), or None when it
    cannot be built or loaded, or when ``DISMEMBER_NO_NATIVE`` is set."""
    global _lib, _tried
    if os.environ.get("DISMEMBER_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            _lib = _load(SOURCE, "host", _bind, "native host library")
        return _lib


def get_serve_lib():
    """The loaded serving library (``csrc/serve_ops.cc``; built on first
    call), or None as :func:`get_lib`."""
    global _serve_lib, _serve_tried
    if os.environ.get("DISMEMBER_NO_NATIVE"):
        return None
    with _lock:
        if _serve_lib is None and not _serve_tried:
            _serve_tried = True
            _serve_lib = _load(SERVE_SOURCE, "serve", _bind_serve, "native serving library")
        return _serve_lib


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _check_arrays(fn: str, *specs) -> None:
    """The C functions read and write through raw pointers: a wrong dtype or
    a strided array would be misread or miswritten, so these stay hard
    errors (no ``assert``, which ``-O`` strips)."""
    for name, arr, want in specs:
        if arr.dtype != want or not arr.flags.c_contiguous:
            raise TypeError(
                f"{fn}: {name} must be C-contiguous {np.dtype(want).name}, got {arr.dtype}"
                f"{'' if arr.flags.c_contiguous else ' (non-contiguous)'}")


def dr_greedy_select_native(
    cand_idx, cand_scores, occ_rows, path_size, sel_idx,
    num_iteration: int, penalty_factor: float, q: float,
) -> bool:
    """DR coordinate descent's greedy J-path select (``dm_dr_greedy_select``):
    the numpy loop of ``train/dr_coordinate.coordinate_descent`` with the
    same libm calls, argmax and NaN semantics, so the selections equal it
    bit for bit on the same host.  Mutates ``path_size``/``sel_idx`` in
    place; returns False (the caller takes the Python loop) when the library
    is unavailable or a row has more than 64 candidates (the C buffer)."""
    lib = get_lib()
    n_rows, n_cand = cand_idx.shape
    if lib is None or n_cand > 64:
        return False
    _check_arrays("dr_greedy_select_native",
                  ("cand_idx", cand_idx, np.int64), ("cand_scores", cand_scores, np.float64),
                  ("occ_rows", occ_rows, np.int64), ("path_size", path_size, np.int64),
                  ("sel_idx", sel_idx, np.int64))
    if cand_scores.shape != cand_idx.shape or occ_rows.shape != (n_rows,) \
            or sel_idx.shape[0] != n_rows:
        raise ValueError("dr_greedy_select_native: cand_scores, occ_rows and sel_idx must "
                         f"have cand_idx's {n_rows} rows")
    if cand_idx.size and not 0 <= cand_idx.min() <= cand_idx.max() < len(path_size):
        raise ValueError("dr_greedy_select_native: cand_idx indexes past path_size")
    lib.dm_dr_greedy_select(
        n_rows, sel_idx.shape[1], n_cand, num_iteration,
        _ptr(cand_idx, ctypes.c_int64), _ptr(cand_scores, ctypes.c_double),
        _ptr(occ_rows, ctypes.c_int64), _ptr(path_size, ctypes.c_int64),
        _ptr(sel_idx, ctypes.c_int64), float(penalty_factor), float(q))
    return True


def cooc_apply_native(
    starts: np.ndarray, segs: np.ndarray, src: np.ndarray,
    wn: np.ndarray, f: np.ndarray, g: np.ndarray,
    n_threads: int | None = None,
) -> bool:
    """The co-occurrence operator pass ``g[dst] += f[src] * wn``
    (``dm_cooc_apply``) over threads that own disjoint output rows.  Each
    segment sums its edges in order, where numpy's ``reduceat`` sums
    pairwise: the two differ by ~1 ulp, and the result does not depend on
    the thread count.  Mutates ``g``; returns False (the caller takes the
    numpy form) when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    _check_arrays("cooc_apply_native",
                  ("starts", starts, np.int64), ("segs", segs, np.int64),
                  ("src", src, np.int64), ("wn", wn, np.float32),
                  ("f", f, np.float32), ("g", g, np.float32))
    if f.shape != g.shape or len(starts) != len(segs) or len(wn) != len(src):
        raise ValueError("cooc_apply_native: f/g, starts/segs or src/wn differ in shape")
    for name, idx, bound in (("src", src, len(f)), ("segs", segs, len(f)),
                             ("starts", starts, max(len(src), 1))):
        if idx.size and not 0 <= idx.min() <= idx.max() < bound:
            raise ValueError(f"cooc_apply_native: {name} indexes past its array")
    lib.dm_cooc_apply(
        len(segs), f.shape[1], n_threads or os.cpu_count() or 1,
        _ptr(starts, ctypes.c_int64), _ptr(segs, ctypes.c_int64),
        len(src), _ptr(src, ctypes.c_int64), _ptr(wn, ctypes.c_float),
        _ptr(f, ctypes.c_float), _ptr(g, ctypes.c_float))
    return True


def filter_topk_native(item_ids, scores, cons, cons_len, k: int):
    """The consumed filter and final top-k of ``tree_beam.filter_topk``
    (``dm_filter_topk``): ``(top, counts)``, row ``i``'s kept ids in
    ``top[i, :counts[i]]`` of ``top`` [B, k] int64, bit for bit the numpy
    form's; ``cons`` holds the rows' consumed ids one after another,
    ``cons_len[i]`` of them for row ``i``.  None when the serving library
    is unavailable."""
    lib = get_serve_lib()
    if lib is None:
        return None
    _check_arrays("filter_topk_native",
                  ("item_ids", item_ids, np.int64), ("scores", scores, np.float32),
                  ("cons", cons, np.int64), ("cons_len", cons_len, np.int64))
    b, w = item_ids.shape
    if scores.shape != (b, w) or cons_len.shape != (b,) or cons.ndim != 1:
        raise ValueError("filter_topk_native: scores, cons_len or cons do not fit item_ids "
                         f"{item_ids.shape}")
    if b and (cons_len.min() < 0 or cons_len.sum() != len(cons)):
        raise ValueError("filter_topk_native: cons_len does not split cons")
    if not 0 <= k <= w < 1 << 31:  # a slot's key holds its column in 31 bits
        raise ValueError(f"filter_topk_native: k {k} outside [0, {w}], or {w} columns")
    top = np.empty((b, k), np.int64)
    counts = np.empty(b, np.int64)
    lib.dm_filter_topk(b, w, k, _ptr(item_ids, ctypes.c_int64), _ptr(scores, ctypes.c_float),
                       _ptr(cons, ctypes.c_int64), _ptr(cons_len, ctypes.c_int64),
                       _ptr(top, ctypes.c_int64), _ptr(counts, ctypes.c_int64))
    return top, counts


def parse_csv_native(path: str):
    """CSV ingest: ``(users, items, categories, labels, timestamps,
    category_names)`` as ``ingest.read_csv`` fills them, or None when the
    library is unavailable or the file cannot be read."""
    lib = get_lib()
    if lib is None:
        return None
    res = lib.dm_parse_csv(str(path).encode("utf-8"))
    if not res:
        return None
    try:
        r = res.contents
        arr = lambda p: np.ctypeslib.as_array(p, (r.n_rows,)).copy()  # noqa: E731
        users, items, timestamps = arr(r.users), arr(r.items), arr(r.timestamps)
        labels, cats = arr(r.labels), arr(r.categories)
        names = (r.category_names or b"").decode("utf-8")
    finally:
        lib.dm_free_csv(res)
    return users, items, cats, labels, timestamps, names.split("\n") if names else []


def user_interactions_native(users: np.ndarray, items: np.ndarray, timestamps: np.ndarray):
    """user -> time-sorted distinct items, as ``ingest.user_interactions``
    groups them; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    timestamps = np.ascontiguousarray(timestamps, dtype=np.int64)
    if not len(users) == len(items) == len(timestamps):
        raise ValueError("user_interactions_native: users, items and timestamps differ in length")
    res = lib.dm_user_interactions(_ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64),
                                   _ptr(timestamps, ctypes.c_int64), len(users))
    if not res:
        return None
    try:
        r = res.contents
        nu = r.n_users
        uu = np.ctypeslib.as_array(r.unique_users, (nu,)).copy()
        off = np.ctypeslib.as_array(r.offsets, (nu + 1,)).copy()
        stream = np.ctypeslib.as_array(r.items_concat, (r.n_items_total,)).copy()
    finally:
        lib.dm_free_interactions(res)
    return {int(uu[i]): stream[off[i] : off[i + 1]] for i in range(nu)}


def scan_kv_records_native(data: bytes):
    """(offsets, lengths) of the KV file framing's records, or None."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(16, len(data) // 8)
    offsets = np.empty(cap, dtype=np.int64)
    lengths = np.empty(cap, dtype=np.int64)
    count = lib.dm_scan_kv_records(data, len(data), _ptr(offsets, ctypes.c_int64),
                                   _ptr(lengths, ctypes.c_int64), cap)
    return offsets[:count], lengths[:count]


def write_tree_native(path, leaf_ids, leaf_codes, leaf_probs,
                      anc_codes, anc_ids, anc_probs, max_level) -> bool:
    """Serialize a built tree (``tree_io.build_tree``'s leaves in code
    order and ancestors) in one native pass; False when the library is
    unavailable or the file cannot be written."""
    lib = get_lib()
    if lib is None:
        return False
    i64 = lambda a: np.ascontiguousarray(a, np.int64)  # noqa: E731
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    leaf_ids, leaf_codes, anc_codes, anc_ids = map(i64, (leaf_ids, leaf_codes, anc_codes,
                                                         anc_ids))
    leaf_probs, anc_probs = f32(leaf_probs), f32(anc_probs)
    if not (len(leaf_ids) == len(leaf_codes) == len(leaf_probs)
            and len(anc_codes) == len(anc_ids) == len(anc_probs)):
        raise ValueError("write_tree_native: leaf or ancestor arrays differ in length")
    ret = lib.dm_write_tree(
        str(path).encode("utf-8"), len(leaf_ids),
        _ptr(leaf_ids, ctypes.c_int64), _ptr(leaf_codes, ctypes.c_int64),
        _ptr(leaf_probs, ctypes.c_float), len(anc_codes),
        _ptr(anc_codes, ctypes.c_int64), _ptr(anc_ids, ctypes.c_int64),
        _ptr(anc_probs, ctypes.c_float), int(max_level))
    return ret >= 0


def read_tree_native(path):
    """The fields of ``tree_io.LoadedTree`` as a dict, or None when the
    library is unavailable or the file is missing or malformed."""
    lib = get_lib()
    if lib is None or not os.path.exists(path):
        return None
    res = lib.dm_read_tree(str(path).encode("utf-8"))
    if not res:
        return None
    try:
        r = res.contents
        nn, npair = r.n_nodes, r.n_pairs
        arr = lambda p, n: np.ctypeslib.as_array(p, (n,)).copy()  # noqa: E731
        return dict(
            max_level=int(r.max_level),
            item_ids=arr(r.pair_ids, npair),
            leaf_codes=arr(r.pair_codes, npair),
            node_codes=arr(r.node_codes, nn),
            node_ids=arr(r.node_ids, nn),
            node_probs=arr(r.node_probs, nn),
            node_is_leaf=arr(r.node_is_leaf, nn).astype(bool),
        )
    finally:
        lib.dm_free_tree(res)
