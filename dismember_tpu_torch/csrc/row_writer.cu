// Row scatter kernels for Hopper (sm_90a), bound through a plain C interface.
//
// K2 write_rows_f32   replaces dismember_tpu/ops/row_writer.py _pallas_write
//                     (entry write_rows_128): in place table[idx[i]] = rows[i]
//                     on an f32 [P, W] table.  The DMA-scheduling spikes
//                     scripts/spike_pallas_scatter.py serial_kernel and
//                     piped_kernel and scripts/spike_pallas_scatter128.py
//                     piped_write compute the same function at other widths.
//    add_rows_f32     replaces scripts/spike_pallas_scatter128.py piped_rmw:
//                     in place table[idx[i]] += rows[i] for unique idx.
//
// A row copy is a pure memory operation: it is bound by bytes (each row read
// once, each table row written once, the add also reads the old row).  The
// TPU kernel pipelines one DMA per row because its rows must be 512-byte
// aligned HBM slices; here every thread moves one float4 (16 bytes) of one
// row, so a warp covers a 128-lane row (or several narrower rows) with
// coalesced 16-byte accesses, and the card keeps many rows in flight by
// itself.  The row index is read once per thread from a broadcast load.
// Indices outside [0, P) are dropped, as the reference's scatter-set
// fallback (mode="drop") does.  Duplicate indices are allowed for
// write_rows_f32 only where they carry equal payloads (the scratch row of
// the packed Adam states): every writer then stores the same bytes.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(float* __restrict__ table, const long long* __restrict__ idx,
                const float* __restrict__ rows, long long P, long long n_vec, int vec_per_row) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / vec_per_row;
    const int c = (int)(i - r * vec_per_row);
    const long long dst = __ldg(idx + r);
    if (dst < 0 || dst >= P) continue;
    const float4 v = __ldg(reinterpret_cast<const float4*>(rows) + i);
    float4* out = reinterpret_cast<float4*>(table) + dst * vec_per_row + c;
    if constexpr (kAdd) {
      const float4 o = *out;
      *out = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    } else {
      *out = v;
    }
  }
}

template <bool kAdd>
int launch(float* table, const long long* idx, const float* rows, long long P, int R, int W,
           void* stream) {
  if (W <= 0 || W % 4 != 0 || R < 0 || P < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const long long n_vec = (long long)R * (W / 4);
  // at most 8 resident blocks of 256 threads on each of 132 SMs; larger
  // calls stride
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  rows_kernel<kAdd><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, rows, P, n_vec, W / 4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes: table [P, W] f32 (W a multiple of 4, rows 16-byte aligned),
// idx [R] int64, rows [R, W] f32.  table[idx[i]] = rows[i].
int write_rows_f32(float* table, const long long* idx, const float* rows, long long P,
                   int R, int W, void* stream) {
  return launch<false>(table, idx, rows, P, R, W, stream);
}

// As write_rows_f32, but table[idx[i]] += rows[i]; idx must be unique.
int add_rows_f32(float* table, const long long* idx, const float* rows, long long P, int R,
                 int W, void* stream) {
  return launch<true>(table, idx, rows, P, R, W, stream);
}

}  // extern "C"
