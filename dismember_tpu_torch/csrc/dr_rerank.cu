// Deep Retrieval's block rerank for Hopper (sm_90a), bound through a plain C
// interface.
//
// dr_block_rerank_topk  replaces no Pallas kernel: it replaces the XLA chain
//                       that the JAX package's block serving route runs after
//                       the path beam (dismember_tpu/retrieval/dr_serve.py:413
//                       _score_blocks_topk, and the path keys, the path-table
//                       lookup and the block gather before it), which the
//                       port ran as ~100 plain PyTorch operations over a
//                       gathered [B, beam, m_pad, planes] bf16 block.
//
// Per query row it takes the beam's paths [beam, D] (int64 node indices),
// computes each path's base-K key, looks it up in the dense path table
// (int32 row index or -1), keeps the live first copy of every row (a padded
// beam repeats a path), reads the kept paths' rows of the block table
// [n_paths, m_pad, planes] bf16 where they lie, scores every valid slot,
// drops the row's consumed ids and keeps the top k distinct items by (score
// descending, id ascending).  It writes only the k ids (int64, -1 past the
// row's items) and scores (f32, -3.4e38 there).
//
// A slot holds planes [0, E) weights, E the bias, E+1 .. E+4 the item id's
// four base-256 digits (exact bf16 integers), E+5 the valid flag, then
// padding.  Its score is the plain route's, bit for bit: the user vector is
// rounded to bf16, each product w_l * u_l is an f32 multiply and the sum an
// f32 add in the order l = 0 .. E-1, then the bias is added (__fmul_rn and
// __fadd_rn, so nothing contracts into an FMA; a product of two bf16 values
// is exact in f32 anyway).  An item sits on at most J paths and its copies
// carry identical scores (the same stored row, the same arithmetic), so
// (score, id) orders distinct items strictly and a copy is recognised by its
// id: the kernel's top k distinct items are the plain route's top (k J)
// followed by the dedup.
//
// Bound: bytes.  A slot is ~33 operations against its 2(E+6) used bytes, so
// the kernel is a gather of random rows (1,536 bytes at E = 16, m_pad 32),
// and what counts is keeping enough row reads in flight to cover their
// latency.  A warp serves one query row (8 rows a 256-thread block, ~40
// registers at E = 16, so nearly every row of a batch of 8,192 is resident
// at once); a path's slots are read by adjacent lanes, each lane the used
// planes of its slot in 16-byte loads (4-byte ones where a slot is not a
// whole number of 16-byte vectors), straight into registers; nothing is
// gathered to device memory.  Items are packed at the front of a row, so a
// path is read in groups of up to 16 slots (two paths a warp pass at m_pad
// 32) and the next group only where the group's last slot is valid: at the
// cell's ~8 items a path that reads about half of each row.  Selection runs
// in shared memory: a sorted list of at most k entries a warp; a slot that
// beats the list's last entry is checked against the row's consumed ids
// (staged in shared memory, the first kConsumedShared of them) and the
// list's ids, then inserted by the warp.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// no launch, for a shape outside the limits below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 256;        // paths a query row
constexpr int kMaxK = 256;           // items a query row returns
constexpr int kConsumedShared = 64;  // consumed ids of a row staged in shared memory
constexpr int kIdDigits = 4;         // base-256 digits of an item id
constexpr int kGroupSlots = 16;      // slots of a path read at once, at most
constexpr float kNegInf = -3.4e38f;  // the score past a row's items

// (score, id) a before b: higher score first, then the lower id
__device__ __forceinline__ bool before(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Plane l of a slot held as 32-bit words (two bf16 a word, plane 2i low).
template <int kWords>
__device__ __forceinline__ float plane(const unsigned (&w)[kWords], int l) {
  const unsigned x = w[l >> 1];
  return __uint_as_float((l & 1) ? (x & 0xffff0000u) : (x << 16));
}

// Shared memory of one warp, in bytes, for a row of cc consumed ids.
__host__ __device__ inline int warp_smem_bytes(int e, int beam, int cc, int k) {
  const int cs = cc < kConsumedShared ? cc : kConsumedShared;
  const int bytes = 8 * cs + 4 * e + 8 * k + 8 * beam;
  return (bytes + 15) / 16 * 16;
}

// V: the load unit (uint4 where a slot is a whole number of 16-byte vectors,
// else unsigned).
template <int E, typename V>
__global__ void __launch_bounds__(kThreads)
    dr_rerank_kernel(const long long* __restrict__ paths, const int* __restrict__ path_table,
                     long long table_size, const __nv_bfloat16* __restrict__ blocks,
                     long long n_paths, const float* __restrict__ user_vec,
                     const long long* __restrict__ consumed, long long* __restrict__ ids_out,
                     float* __restrict__ scores_out, int B, int beam, int D, int K, int planes,
                     int m_pad, int cc, int k) {
  constexpr int kUsed = E + 2 + kIdDigits;  // weights, bias, digits, valid
  constexpr int kPerV = sizeof(V) / 2;      // bf16 a load
  constexpr int kLoads = (kUsed + kPerV - 1) / kPerV;
  constexpr int kWordsPerV = sizeof(V) / 4;
  constexpr int kWords = kLoads * kWordsPerV;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // a whole warp; nothing below syncs the block
  unsigned char* base = smem + warp * warp_smem_bytes(E, beam, cc, k);
  const int cs = cc < kConsumedShared ? cc : kConsumedShared;
  long long* s_cons = reinterpret_cast<long long*>(base);
  float* s_u = reinterpret_cast<float*>(s_cons + cs);
  float* s_score = s_u + E;
  int* s_id = reinterpret_cast<int*>(s_score + k);
  int* s_rows = s_id + k;     // [beam] the beam's rows (-1: none)
  int* s_live = s_rows + beam;  // the live first copies, in beam order

  const long long* g_cons = consumed + (long long)b * cc;
  for (int c = lane; c < cs; c += 32) s_cons[c] = g_cons[c];
  for (int l = lane; l < E; l += 32)
    s_u[l] = __bfloat162float(__float2bfloat16_rn(user_vec[(long long)b * E + l]));
  const long long* p = paths + (long long)b * beam * D;
  for (int q = lane; q < beam; q += 32) {
    long long key = 0;
    for (int d = 0; d < D; ++d) key = key * K + __ldg(p + q * D + d);
    const int row = key >= 0 && key < table_size ? __ldg(path_table + key) : -1;
    s_rows[q] = row >= 0 && row < n_paths ? row : -1;
  }
  __syncwarp();
  int n_live = 0;
  for (int q0 = 0; q0 < beam; q0 += 32) {
    const int q = q0 + lane;
    const int row = q < beam ? s_rows[q] : -1;
    bool live = row >= 0;
    for (int r = 0; r < q && live; ++r) live = s_rows[r] != row;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (live) s_live[n_live + __popc(m & ((1u << lane) - 1))] = row;
    n_live += __popc(m);
  }
  __syncwarp();

  // a path's slots in groups of sg (the least power of two >= m_pad, at
  // most kGroupSlots), 32 / sg paths a pass
  int sg = kGroupSlots;
  while (sg > 1 && sg / 2 >= m_pad) sg >>= 1;
  const int g = lane / sg, sl = lane % sg;
  const long long row_elems = (long long)planes * m_pad;
  int n = 0;  // entries in the list, the same in every lane
  for (int p0 = 0; p0 < n_live; p0 += 32 / sg) {
    const bool has = p0 + g < n_live;
    const __nv_bfloat16* row = blocks + (has ? s_live[p0 + g] * row_elems : 0);
    bool more = has;
    for (int s0 = 0; __any_sync(0xffffffffu, more); s0 += sg) {
      const int slot = s0 + sl;
      const bool act = more && slot < m_pad;
      unsigned w[kWords];
      if (act) {
        const V* src = reinterpret_cast<const V*>(row + (long long)slot * planes);
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const V v = __ldg(src + j);
          if constexpr (kWordsPerV == 4) {
            w[4 * j] = v.x, w[4 * j + 1] = v.y, w[4 * j + 2] = v.z, w[4 * j + 3] = v.w;
          } else {
            w[j] = v;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWords; ++j) w[j] = 0;
      }
      const bool valid = plane(w, E + 1 + kIdDigits) > 0.f;
      float score = __fmul_rn(plane(w, 0), s_u[0]);
#pragma unroll
      for (int l = 1; l < E; ++l) score = __fadd_rn(score, __fmul_rn(plane(w, l), s_u[l]));
      score = __fadd_rn(score, plane(w, E));
      int id = 0;
#pragma unroll
      for (int d = 0; d < kIdDigits; ++d) id = id * 256 + (int)plane(w, E + 1 + d);
      // the group's last slot valid: the path may hold more
      const bool full = __shfl_sync(0xffffffffu, valid, g * sg + sg - 1);
      more = more && full && s0 + sg < m_pad;

      const bool beat =
          act && valid && (n < k || before(score, id, s_score[k - 1], s_id[k - 1]));
      unsigned want = __ballot_sync(0xffffffffu, beat);
      while (want) {
        const int src = __ffs(want) - 1;
        want &= want - 1;
        const float cs_score = __shfl_sync(0xffffffffu, score, src);
        const int cid = __shfl_sync(0xffffffffu, id, src);
        if (n == k && !before(cs_score, cid, s_score[k - 1], s_id[k - 1])) continue;
        bool hit = false;
        for (int c = lane; c < cc; c += 32)
          hit |= (c < kConsumedShared ? s_cons[c] : __ldg(g_cons + c)) == (long long)cid;
        if (__any_sync(0xffffffffu, hit)) continue;
        bool dup = false;
        int ahead = 0;
        for (int i = lane; i < n; i += 32) {
          dup |= s_id[i] == cid;
          ahead += before(s_score[i], s_id[i], cs_score, cid);
        }
        if (__any_sync(0xffffffffu, dup)) continue;
        const int pos = __reduce_add_sync(0xffffffffu, ahead);
        const int nn = n < k ? n + 1 : k;
        // entries [pos, nn - 1) move one place down, the last first
        for (int top = nn - 1; top > pos; top -= 32) {
          const int i = top - lane;
          const bool mv = i > pos;
          float ms = 0.f;
          int mi = 0;
          if (mv) ms = s_score[i - 1], mi = s_id[i - 1];
          __syncwarp();
          if (mv) s_score[i] = ms, s_id[i] = mi;
          __syncwarp();
        }
        if (lane == 0) s_score[pos] = cs_score, s_id[pos] = cid;
        __syncwarp();
        n = nn;
      }
    }
  }
  for (int i = lane; i < k; i += 32) {
    const bool f = i < n;
    ids_out[(long long)b * k + i] = f ? (long long)s_id[i] : -1;
    scores_out[(long long)b * k + i] = f ? s_score[i] : kNegInf;
  }
}

template <int E>
int launch_rerank(const long long* paths, const int* path_table, long long table_size,
                  const __nv_bfloat16* blocks, long long n_paths, const float* user_vec,
                  const long long* consumed, long long* ids, float* scores, int B, int beam,
                  int D, int K, int planes, int m_pad, int cc, int k, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  const int smem = kWarps * warp_smem_bytes(E, beam, cc, k);
  if (planes % 8 == 0)
    dr_rerank_kernel<E, uint4><<<grid, kThreads, smem, stream>>>(
        paths, path_table, table_size, blocks, n_paths, user_vec, consumed, ids, scores, B,
        beam, D, K, planes, m_pad, cc, k);
  else
    dr_rerank_kernel<E, unsigned><<<grid, kThreads, smem, stream>>>(
        paths, path_table, table_size, blocks, n_paths, user_vec, consumed, ids, scores, B,
        beam, D, K, planes, m_pad, cc, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes: paths [B, beam, D] int64, path_table [table_size] int32 (row or
// -1), blocks [n_paths, m_pad, planes] bf16 (16-byte aligned), user_vec
// [B, E] f32, consumed [B, cc] int64 (-1 pads; null when cc is 0); out ids
// [B, k] int64 and scores [B, k] f32.  Built for E = 8, 16, 32, 64, 96;
// planes even and at least E + 6; beam <= kMaxBeam; k <= kMaxK and at most
// beam * m_pad.
int dr_block_rerank_topk(const long long* paths, const int* path_table, long long table_size,
                         const void* blocks, long long n_paths, const float* user_vec,
                         const long long* consumed, long long* ids, float* scores, int B,
                         int beam, int D, int K, int E, int planes, int m_pad, int cc, int k,
                         void* stream) {
  if (B < 0 || beam < 1 || beam > kMaxBeam || D < 1 || K < 1 || k < 1 || k > kMaxK ||
      m_pad < 1 || (long long)k > (long long)beam * m_pad || planes % 2 || planes < E + 6 ||
      cc < 0 || (cc > 0 && consumed == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* blk = static_cast<const __nv_bfloat16*>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
#define DR_RERANK_CASE(W)                                                                    \
  case W:                                                                                    \
    return launch_rerank<W>(paths, path_table, table_size, blk, n_paths, user_vec, consumed, \
                            ids, scores, B, beam, D, K, planes, m_pad, cc, k, s);
  switch (E) {
    DR_RERANK_CASE(8)
    DR_RERANK_CASE(16)
    DR_RERANK_CASE(32)
    DR_RERANK_CASE(64)
    DR_RERANK_CASE(96)
    default:
      return cudaErrorInvalidValue;
  }
#undef DR_RERANK_CASE
}

}  // extern "C"
