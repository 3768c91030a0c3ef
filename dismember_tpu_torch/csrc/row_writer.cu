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
//    add_rows_bf16    the same add on a bf16 table with bf16 rows: the
//                     JAX package's scatter-add into a bf16 table
//                     (table.at[idx].add(rows.astype(bf16))).
//
// A row copy is a pure memory operation: it is bound by bytes (each row read
// once, each table row written once, the add also reads the old row).
// Indices outside [0, P) are dropped, as the reference's scatter-set
// fallback (mode="drop") does.  Duplicate indices are allowed for
// write_rows_f32 only where they carry equal payloads (the scratch row of
// the packed Adam states): every writer then stores the same bytes.
//
// All run one kernel, write_kernel<kAdd, T> on 16-byte vectors of the
// table's element type T (4 floats or 8 bf16).  The bf16 add converts the
// old row and the payload to f32, adds, and rounds each sum once to bf16
// (nearest even): the correctly rounded bf16 sum, since an f32 sum of two
// bf16 values rounds innocuously, which is the value of the JAX package's
// CPU scatter-add.  It is built around what the
// packed Adam commit hands write_rows_f32: the sorted distinct physical rows
// a step touches, then a tail of entries that all repeat the scratch row
// with zero payloads (about a quarter of the rows at the 1M catalog).  A
// warp handles a group of rows: a row takes lpr lanes (the power of two >=
// W/4, at most 32), a pass covers 32/lpr rows, and a group is up to kPasses
// passes (a 128-lane row: one row a pass, four rows a group), so a lane has
// up to kPasses 16-byte payload loads in flight before its stores (the add:
// kPasses payload and old-row loads).  One lane per row loads the row's
// index, and __shfl_sync hands it to the row's lanes; a row aimed outside
// [0, P) loads nothing.  The write also loads its predecessor's index and
// skips a row whose index equals it: the contract makes that write a no-op,
// so a run of repeated scratch entries costs one row write, not one per
// entry; non-adjacent repeats are still written.  The add skips nothing:
// its indices must be unique, and a skip would turn a wrong call into a
// silently wrong sum.  Payload rows are read once and the written rows are
// not read again by the kernel, so both go with streaming hints (__ldcs,
// __stcs).  Offsets are 32-bit (tables and row blocks of 2^32 float4s, 64
// GiB, or more are refused) and nothing divides.  The grid covers the
// groups with at most kBlocksPerSm blocks on each of the device's SMs;
// larger calls stride.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 4;  // 16-byte loads a lane keeps in flight
constexpr int kBlocksPerSm = 2048 / kThreads;

// 16 bytes of a row of T, and their elementwise sum.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;  // 8 bf16
  static __device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
    const __nv_bfloat162 z = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    return *reinterpret_cast<const unsigned*>(&z);
  }
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z), add2(a.w, b.w));
  }
};

// kAdd = false: table[idx[i]] = rows[i], adjacent repeats skipped;
// kAdd = true: table[idx[i]] += rows[i], nothing skipped.  vpr: 16-byte
// vectors a row.
template <bool kAdd, typename T>
__global__ void __launch_bounds__(kThreads)
    write_kernel(typename Vec<T>::type* __restrict__ table, const long long* __restrict__ idx,
                 const typename Vec<T>::type* __restrict__ rows, long long P, int R, int vpr,
                 int lpr_log2, int passes) {
  using V = typename Vec<T>::type;
  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log2;       // lanes a row
  const int rpp = 32 >> lpr_log2;      // rows a pass
  const int group = rpp * passes;      // rows a group, at most 32
  const int sub = lane >> lpr_log2, col = lane & (lpr - 1);
  const int stride = gridDim.x * kWarps * group;
  for (int base = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * group; base < R;
       base += stride) {
    // lane l: row base + l's index and whether that row is written
    long long dst = 0;
    int write = 0;
    if (lane < group && base + lane < R) {
      dst = __ldg(idx + base + lane);
      if constexpr (kAdd) {
        write = dst >= 0 && dst < P;
      } else {
        const long long prev = base + lane > 0 ? __ldg(idx + base + lane - 1) : -1;
        write = dst >= 0 && dst < P && dst != prev;
      }
    }
    for (int c0 = 0; c0 < vpr; c0 += lpr) {  // one step for W <= 128
      const int c = c0 + col;
      V v[kPasses], old[kPasses];
      unsigned to[kPasses];
      bool w[kPasses];
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int r = (u * rpp + sub) & 31;
        const long long d = __shfl_sync(0xffffffffu, dst, r);
        w[u] = __shfl_sync(0xffffffffu, write, r) && u < passes && c < vpr;
        to[u] = (unsigned)d * vpr + c;
        if (w[u]) {
          v[u] = __ldcs(rows + (unsigned)(base + r) * vpr + c);
          if constexpr (kAdd) old[u] = __ldcg(table + to[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPasses; ++u)
        if (w[u]) {
          if constexpr (kAdd) v[u] = Vec<T>::add(old[u], v[u]);
          __stcs(table + to[u], v[u]);
        }
    }
  }
}

// W: elements of T a row, a whole number of 16-byte vectors.
template <bool kAdd, typename T>
int launch_rows(T* table, const long long* idx, const T* rows, long long P, int R, int W,
                cudaStream_t stream) {
  using V = typename Vec<T>::type;
  const int vpr = W * (int)sizeof(T) / 16;
  if ((unsigned long long)P * vpr >= (1ull << 32) || (unsigned long long)R * vpr >= (1ull << 32))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < vpr && lpr_log2 < 5) ++lpr_log2;
  const int passes = (1 << lpr_log2) < kPasses ? (1 << lpr_log2) : kPasses;
  const int group = (32 >> lpr_log2) * passes;
  const long long want = ((long long)R + (long long)group * kWarps - 1) / (group * kWarps);
  const int blocks = (int)std::min(want, (long long)sms * kBlocksPerSm);
  if ((long long)R + (long long)blocks * kWarps * group > INT_MAX) return cudaErrorInvalidValue;
  write_kernel<kAdd, T><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<V*>(table), idx, reinterpret_cast<const V*>(rows), P, R, vpr, lpr_log2,
      passes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes: table [P, W] f32 (W a multiple of 4, rows 16-byte aligned),
// idx [R] int64, rows [R, W] f32.  table[idx[i]] = rows[i].
int write_rows_f32(float* table, const long long* idx, const float* rows, long long P,
                   int R, int W, void* stream) {
  if (W <= 0 || W % 4 != 0 || R < 0 || P < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  return launch_rows<false>(table, idx, rows, P, R, W, static_cast<cudaStream_t>(stream));
}

// As write_rows_f32, but table[idx[i]] += rows[i]; idx must be unique.
int add_rows_f32(float* table, const long long* idx, const float* rows, long long P, int R,
                 int W, void* stream) {
  if (W <= 0 || W % 4 != 0 || R < 0 || P < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  return launch_rows<true>(table, idx, rows, P, R, W, static_cast<cudaStream_t>(stream));
}

// As add_rows_f32 on a bf16 table [P, W] with bf16 rows [R, W], W a
// multiple of 8 (rows 16-byte aligned): each sum rounded once to bf16.
int add_rows_bf16(void* table, const long long* idx, const void* rows, long long P, int R,
                  int W, void* stream) {
  if (W <= 0 || W % 8 != 0 || R < 0 || P < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  return launch_rows<true>(static_cast<__nv_bfloat16*>(table), idx,
                           static_cast<const __nv_bfloat16*>(rows), P, R, W,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
