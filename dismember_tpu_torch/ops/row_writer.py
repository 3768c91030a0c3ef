"""K2: in-place row writes into f32 tables, and the row scatter-add.

Replaces the Pallas kernel ``dismember_tpu/ops/row_writer.py::_pallas_write``
(entry ``write_rows_128``), which commits every packed lazy-Adam step
(``train/sparse_adam.py``), and the spike kernels that prototyped it:
``scripts/spike_pallas_scatter.py`` ``serial_kernel``/``piped_kernel`` and
``scripts/spike_pallas_scatter128.py`` ``piped_write`` (the same function as
K2 at other widths) and ``piped_rmw`` (:func:`add_rows`).

:func:`write_rows` and :func:`add_rows` launch ``write_rows_f32`` and
``add_rows_f32`` (``csrc/row_writer.cu``) for CUDA tensors and run their
plain versions (``index_copy_``/``index_add_``) for CPU tensors.  Both take
an f32 [P, W] table with W a multiple of 4, int64 indices and [R, W] rows,
update the table in place and return it; indices outside [0, P) are
dropped.  :func:`add_rows` also takes a bf16 table with bf16 rows (W a
multiple of 8; ``add_rows_bf16``): each sum is computed in f32 and rounded
once to bf16, the value of the JAX package's scatter-add into a bf16 table
(the mv step's update of a bf16 embedding table).  On the H100 both are
bound by bytes: a row is read once and written once (the add reads the old
row too).  Both run one kernel: a warp
writes a row (or a group of narrower rows), one lane loads each row's index
and shuffles it to the row's lanes, rows aimed out of range load nothing,
and several rows' loads are in flight before their stores.  K2 skips a row
whose index equals its predecessor's (the packed Adam commit ends in a run
of entries that all repeat its scratch row, which then costs one write);
the add, whose indices must be unique, skips none.  The add serves the mv
step's table update (``train/sparse_adam.py``) and the JTM sweep's weight
accumulator (``train/jtm.py`` ``add_runs``).
"""

from __future__ import annotations

import torch

from dismember_tpu_torch.ops import _cuda

# launches on CUDA tensors (the add on a bf16 table counted apart);
# chip_smoke.py zeroes and reads them
launches = {"write_rows": 0, "add_rows": 0, "add_rows_bf16": 0}


def _kept(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    keep = (idx >= 0) & (idx < table.shape[0])
    return idx[keep], rows[keep]


def write_rows_plain(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K2's plain version: ``table[idx[i]] = rows[i]`` in place."""
    return table.index_copy_(0, *_kept(table, idx, rows))


def add_rows_plain(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """:func:`add_rows`'s plain version: ``table[idx[i]] += rows[i]`` in place
    (on a bf16 table, each sum rounded once to bf16)."""
    return table.index_add_(0, *_kept(table, idx, rows))


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    dev = table.device
    dtypes = (torch.float32, torch.bfloat16) if name == "add_rows" else (torch.float32,)
    if table.dtype not in dtypes:
        raise ValueError(f"{name}: table is {table.dtype}, expected "
                         + " or ".join(map(str, dtypes)))
    bf16 = table.dtype == torch.bfloat16
    per_vec = 8 if bf16 else 4  # elements of a 16-byte vector
    if table.ndim != 2 or table.shape[1] % per_vec:
        raise ValueError(f"{name}: table must be [P, W] with W a multiple of {per_vec}, "
                         f"got {tuple(table.shape)}")
    _cuda.check_inputs(name, dev, table.dtype, table=table, rows=rows)
    _cuda.check_inputs(name, dev, torch.int64, idx=idx)
    _cuda.check_shape(name, "rows", rows, (idx.shape[0], table.shape[1]))
    kernel = f"{name}_bf16" if bf16 else f"{name}_f32"
    code = getattr(_cuda.library(), kernel)(
        table.data_ptr(), idx.data_ptr(), rows.data_ptr(), table.shape[0], idx.shape[0],
        table.shape[1], _cuda.stream_handle(dev))
    _cuda.check_launch(name, code)
    launches["add_rows_bf16" if bf16 else name] += 1


def _dispatch(name: str, plain, table, idx, rows) -> torch.Tensor:
    dev = table.device
    if dev.type == "cpu":
        return plain(table, idx, rows)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _launch(name, table, idx, rows)
    return table


def write_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] = rows[i]`` in place: K2 for CUDA tensors, the plain
    version for CPU tensors.  Repeated indices must carry equal rows."""
    return _dispatch("write_rows", write_rows_plain, table, idx, rows)


def add_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += rows[i]`` in place for unique ``idx`` (an f32
    table, or a bf16 table with bf16 rows): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return _dispatch("add_rows", add_rows_plain, table, idx, rows)


def write_rows_128(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The JAX package's entry: :func:`write_rows`.  The Pallas kernel pads
    the row count to its 512-row grid step; K2 needs no padding.

    ``idx`` entries must be unique EXCEPT for repeats that carry identical
    payloads (e.g. a sacrificial scratch row)."""
    if idx.shape[0] == 0:
        return table
    return write_rows(table, idx.long().contiguous(), rows.contiguous())
