// Native host pass of the port's serving facade (dismember_tpu_torch).
//
// The consumed filter and final top-k of retrieval/tree_beam.py's
// filter_topk (Recommender.recommendItems in the reference: filterNot
// consumed, sort by score desc, take topk) in one pass over the batch, on
// one thread.  Its lists equal the numpy form's bit for bit.  That form keeps
// a slot whose id is >= 0 and not among the row's consumed ids, takes the
// first topk slots of a stable argsort of -score with the other slots'
// scores set to -inf, and then drops those others.  So here as there an
// unkept slot still takes a place in the order (behind every finite score,
// tied with kept -inf scores and broken by column), and a NaN score sorts
// after every other slot.
//
// A row is worked in vectors of 8 slots (GCC's vector extensions, lowered to
// whatever the host's SIMD is).  Each slot gets a 64-bit key, unique in the
// row and ascending in that argsort; a slot's place in the order is then the
// number of keys below its own.  Counting that for every pair of a row's
// slots is most of the work, so a bound is found first that at least k keys
// are at or below (the k-th smallest of 16 group minima); only the keys at
// or below it can be among the first k, and only they are counted.
// Exposed through a C ABI consumed via ctypes.
//
// Build: dismember_tpu_torch/data/native.py compiles it with g++ at first use
// into build/host/, with the flags of csrc/host_ops.cc.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLanes = 8;  // slots a vector
typedef int64_t i64v __attribute__((vector_size(8 * kLanes)));
typedef int32_t i32v __attribute__((vector_size(4 * kLanes)));
typedef uint32_t u32v __attribute__((vector_size(4 * kLanes)));

// consumed lists up to this length are compared with every slot; longer ones
// are sorted once and binary-searched
constexpr int64_t kScanConsumed = 16;
// a key is (score part << kColumnBits) | column
constexpr int kColumnBits = 31;
constexpr int64_t kColumnMask = (int64_t{1} << kColumnBits) - 1;
// a pad lane's key: past every slot's key (whose score part is at most
// 0xFFFFFFFE), column 0
constexpr int64_t kPadKey = int64_t{0xFFFFFFFF} << kColumnBits;

// The score parts of 8 float32 bit patterns, shifted into place: ascending in
// -score, 0.0 and -0.0 one value, every NaN 0xFFFFFFFE (after -inf's
// 0xFF800000).  Integer operations only, so no floating-point mode enters.
inline i64v score_part(i32v u) {
  u = u == std::numeric_limits<int32_t>::min() ? 0 : u;  // -0.0 -> 0.0
  i32v d = u ^ (~(u >> 31) & 0x7FFFFFFF);
  d = (u & 0x7FFFFFFF) > 0x7F800000 ? -2 : d;  // NaN
  return __builtin_convertvector(reinterpret_cast<u32v>(d), i64v) << kColumnBits;
}

inline i64v splat(int64_t x) { return i64v{} + x; }

}  // namespace

// item_ids, scores: [b, w] row-major (w < 2^31); cons: the rows' consumed ids
// one after another, cons_len[i] of them for row i; out: [b, k] (k <= w), row
// i's kept ids in its first counts[i] places (the rest unwritten).
extern "C" void dm_filter_topk(int64_t b, int64_t w, int64_t k, const int64_t* item_ids,
                               const float* scores, const int64_t* cons,
                               const int64_t* cons_len, int64_t* out, int64_t* counts) {
  if (k <= 0) {
    std::fill(counts, counts + b, 0);
    return;
  }
  const int64_t nv = (w + kLanes - 1) / kLanes;
  // a row's slots; the pad lanes past w keep id -1 and score bits 0
  std::vector<i64v> ids(nv, splat(-1)), column(nv), keys(nv), kept(nv);
  std::vector<i32v> bits(nv, i32v{});
  for (int64_t v = 0; v < nv; ++v) {
    for (int l = 0; l < kLanes; ++l) column[v][l] = v * kLanes + l;
  }
  // the candidates' keys, padded to whole pairs of vectors
  std::vector<i64v> cand_v(nv + 2);
  int64_t* cand = reinterpret_cast<int64_t*>(cand_v.data());
  std::vector<int64_t> place(k + 1), sorted;  // place[k]: where the rest go
  const i64v unkept = score_part(i32v{} + static_cast<int32_t>(0xFF800000u));  // -inf
  const int64_t* c = cons;
  for (int64_t i = 0; i < b; ++i) {
    std::memcpy(ids.data(), item_ids + i * w, w * sizeof(int64_t));
    std::memcpy(bits.data(), scores + i * w, w * sizeof(float));
    const int64_t m = cons_len[i];
    if (m > kScanConsumed) {
      sorted.assign(c, c + m);
      std::sort(sorted.begin(), sorted.end());
    }
    for (int64_t v = 0; v < nv; ++v) {
      const i64v id = ids[v];
      i64v hit{};
      if (m > kScanConsumed) {
        for (int l = 0; l < kLanes; ++l)
          hit[l] = -std::binary_search(sorted.begin(), sorted.end(), id[l]);
      } else {
        for (int64_t t = 0; t < m; ++t) hit |= id == splat(c[t]);
      }
      const i64v ok = (id >= 0) & ~hit;
      kept[v] = ok ? id : -1;
      const i64v key = (ok ? score_part(bits[v]) : unkept) | column[v];
      keys[v] = column[v] < w ? key : kPadKey;
    }

    // the bound: group l of 16 holds lane l % 8 of every other vector; their
    // minima are 16 distinct keys (or pads), so at least k keys lie at or
    // below the k-th smallest of them
    int64_t bound = kPadKey;
    if (k <= 2 * kLanes && nv >= 2) {
      i64v g[2] = {keys[0], keys[1]};
      for (int64_t v = 2; v < nv; ++v) g[v & 1] = keys[v] < g[v & 1] ? keys[v] : g[v & 1];
      const int64_t* gk = reinterpret_cast<const int64_t*>(g);
      i64v below0{}, below1{};  // minus the count of minima below each minimum
      for (int t = 0; t < 2 * kLanes; ++t) {
        below0 += splat(gk[t]) < g[0];
        below1 += splat(gk[t]) < g[1];
      }
      i64v top = splat(std::numeric_limits<int64_t>::min());
      top = -below0 < k && g[0] > top ? g[0] : top;
      top = -below1 < k && g[1] > top ? g[1] : top;
      bound = top[0];
      for (int l = 1; l < kLanes; ++l) bound = std::max<int64_t>(bound, top[l]);
    }
    const int64_t* row_keys = reinterpret_cast<const int64_t*>(keys.data());
    int64_t n = 0;
    for (int64_t j = 0; j < w; ++j) {
      cand[n] = row_keys[j];
      n += row_keys[j] <= bound;
    }
    const int64_t n_pad = (n + 2 * kLanes - 1) / (2 * kLanes) * (2 * kLanes);
    std::fill(cand + n, cand + n_pad, kPadKey);

    // each candidate's place: the candidates' keys below its own (a slot
    // past the bound is past every candidate); pads and places >= k go to
    // place[k]
    const int64_t* kept_ids = reinterpret_cast<const int64_t*>(kept.data());
    for (int64_t v = 0; v * kLanes < n; v += 2) {
      const i64v k0 = cand_v[v], k1 = cand_v[v + 1];
      i64v below0{}, below1{};
      for (int64_t t = 0; t < n; ++t) {
        below0 += splat(cand[t]) < k0;
        below1 += splat(cand[t]) < k1;
      }
      for (int l = 0; l < kLanes; ++l) {
        place[std::min<int64_t>(-below0[l], k)] = kept_ids[k0[l] & kColumnMask];
        place[std::min<int64_t>(-below1[l], k)] = kept_ids[k1[l] & kColumnMask];
      }
    }
    int64_t* o = out + i * k;
    int64_t cnt = 0;
    for (int64_t p = 0; p < k; ++p) {
      o[cnt] = place[p];
      cnt += place[p] >= 0;
    }
    counts[i] = cnt;
    c += m;
  }
}
