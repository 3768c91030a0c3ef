// Native host-side data pipeline of the PyTorch port (dismember_tpu_torch).
//
// The port's copy of the JAX package's native/host_ops.cc, with the same C
// interface, so the two libraries can be compared call for call.  The
// reference's ingest/windowing runs on the JVM with thread pools
// (tdm/.../tree/TreeInit.scala, scalann utils/ThreadPool.scala); here the
// volume-heavy host path is native: CSV parsing with dictionary encoding,
// the time-sort + per-user distinct grouping that precedes windowing, the
// tree codec, DR's greedy path select and the co-occurrence operator pass.
// Exposed through a C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: dismember_tpu_torch/data/native.py compiles it with g++ at first use
// into build/host/ (-O3 -march=native -fPIC -std=c++17 -Wall -pthread
// -ffp-contract=off -shared).

#include <algorithm>
#include <cmath>
#include <limits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV ingest: rows "user,item,label,timestamp,category"; header rows (non-
// numeric first field) skipped; label/category dictionary-encoded in
// first-occurrence order (TreeInit.readFile parity).
// ---------------------------------------------------------------------------

struct CsvResult {
  int64_t n_rows;
  int64_t* users;
  int64_t* items;
  int64_t* timestamps;
  float* labels;
  int32_t* categories;
  char* category_names;  // '\n'-joined, first-occurrence order
  int64_t category_names_len;
};

static bool is_number(const char* s, size_t n) {
  if (n == 0) return false;
  size_t i = 0;
  if (s[0] == '-' || s[0] == '+') i = 1;
  bool any = false;
  for (; i < n; i++) {
    if (s[i] >= '0' && s[i] <= '9') {
      any = true;
    } else if (s[i] != '.' && s[i] != 'e' && s[i] != 'E' && s[i] != '-' &&
               s[i] != '+') {
      return false;
    }
  }
  return any;
}

CsvResult* dm_parse_csv(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<int64_t> users, items, timestamps;
  std::vector<float> labels;
  std::vector<int32_t> cats;
  std::unordered_map<std::string, float> label_dict;
  std::unordered_map<std::string, int32_t> cat_dict;
  std::string cat_names;

  const char* p = buf.data();
  const char* end = p + size;
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // split into 5 fields
    const char* fields[6];
    int nf = 0;
    fields[nf++] = p;
    for (const char* q = p; q < line_end && nf < 6; q++) {
      if (*q == ',') fields[nf++] = q + 1;
    }
    if (nf == 5) {
      const char* f0 = fields[0];
      size_t f0n = (fields[1] - 1) - f0;
      // trim leading whitespace of the first field
      while (f0n > 0 && (*f0 == ' ' || *f0 == '\t' || *f0 == '\r')) {
        f0++;
        f0n--;
      }
      if (is_number(f0, f0n)) {
        users.push_back(strtoll(f0, nullptr, 10));
        items.push_back(strtoll(fields[1], nullptr, 10));
        std::string lab(fields[2], (fields[3] - 1) - fields[2]);
        timestamps.push_back(strtoll(fields[3], nullptr, 10));
        size_t c_len = line_end - fields[4];
        while (c_len > 0 && (fields[4][c_len - 1] == '\r' ||
                             fields[4][c_len - 1] == ' '))
          c_len--;
        std::string cat(fields[4], c_len);

        auto lit = label_dict.find(lab);
        if (lit == label_dict.end()) {
          float code = static_cast<float>(label_dict.size());
          lit = label_dict.emplace(lab, code).first;
        }
        labels.push_back(lit->second);

        auto cit = cat_dict.find(cat);
        if (cit == cat_dict.end()) {
          int32_t code = static_cast<int32_t>(cat_dict.size());
          cit = cat_dict.emplace(cat, code).first;
          if (!cat_names.empty()) cat_names += '\n';
          cat_names += cat;
        }
        cats.push_back(cit->second);
      }
    }
    p = line_end + 1;
  }

  auto* res = new CsvResult();
  res->n_rows = static_cast<int64_t>(users.size());
  res->users = new int64_t[users.size()];
  res->items = new int64_t[items.size()];
  res->timestamps = new int64_t[timestamps.size()];
  res->labels = new float[labels.size()];
  res->categories = new int32_t[cats.size()];
  memcpy(res->users, users.data(), users.size() * sizeof(int64_t));
  memcpy(res->items, items.data(), items.size() * sizeof(int64_t));
  memcpy(res->timestamps, timestamps.data(), timestamps.size() * sizeof(int64_t));
  memcpy(res->labels, labels.data(), labels.size() * sizeof(float));
  memcpy(res->categories, cats.data(), cats.size() * sizeof(int32_t));
  res->category_names_len = static_cast<int64_t>(cat_names.size());
  res->category_names = new char[cat_names.size() + 1];
  memcpy(res->category_names, cat_names.data(), cat_names.size());
  res->category_names[cat_names.size()] = '\0';
  return res;
}

void dm_free_csv(CsvResult* res) {
  if (!res) return;
  delete[] res->users;
  delete[] res->items;
  delete[] res->timestamps;
  delete[] res->labels;
  delete[] res->categories;
  delete[] res->category_names;
  delete res;
}

// ---------------------------------------------------------------------------
// Per-user time-sorted distinct interactions (TreeInit.getUserInteracted
// parity: stable sort by timestamp, group by user, distinct keeping first
// occurrence).  Output: grouped CSR — unique users, offsets, item stream.
// ---------------------------------------------------------------------------

struct InteractionsResult {
  int64_t n_users;
  int64_t n_items_total;
  int64_t* unique_users;   // [n_users]
  int64_t* offsets;        // [n_users + 1]
  int64_t* items_concat;   // [n_items_total]
};

InteractionsResult* dm_user_interactions(const int64_t* users,
                                         const int64_t* items,
                                         const int64_t* timestamps,
                                         int64_t n) {
  // stable sort indices by timestamp, then stably by user
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    return timestamps[a] < timestamps[b];
  });
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    return users[a] < users[b];
  });

  auto* res = new InteractionsResult();
  std::vector<int64_t> uu, off, stream;
  off.push_back(0);
  int64_t i = 0;
  std::unordered_map<int64_t, bool> seen;
  while (i < n) {
    int64_t u = users[idx[i]];
    uu.push_back(u);
    seen.clear();
    while (i < n && users[idx[i]] == u) {
      int64_t it = items[idx[i]];
      if (seen.find(it) == seen.end()) {
        seen.emplace(it, true);
        stream.push_back(it);
      }
      i++;
    }
    off.push_back(static_cast<int64_t>(stream.size()));
  }
  res->n_users = static_cast<int64_t>(uu.size());
  res->n_items_total = static_cast<int64_t>(stream.size());
  res->unique_users = new int64_t[uu.size()];
  res->offsets = new int64_t[off.size()];
  res->items_concat = new int64_t[stream.size()];
  memcpy(res->unique_users, uu.data(), uu.size() * sizeof(int64_t));
  memcpy(res->offsets, off.data(), off.size() * sizeof(int64_t));
  memcpy(res->items_concat, stream.data(), stream.size() * sizeof(int64_t));
  return res;
}

void dm_free_interactions(InteractionsResult* res) {
  if (!res) return;
  delete[] res->unique_users;
  delete[] res->offsets;
  delete[] res->items_concat;
  delete res;
}

// ---------------------------------------------------------------------------
// KV record framing scan (DistTree.loadData parity): split a tree file into
// (offset, length) record spans in one pass so Python decodes protos without
// re-walking the byte stream.
// ---------------------------------------------------------------------------

int64_t dm_scan_kv_records(const uint8_t* data, int64_t size,
                           int64_t* offsets, int64_t* lengths,
                           int64_t cap) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos + 4 <= size && count < cap) {
    int32_t len = (data[pos] << 24) | (data[pos + 1] << 16) |
                  (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (len < 0 || pos + len > size) break;
    offsets[count] = pos;
    lengths[count] = len;
    pos += len;
    count++;
  }
  return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native tree KV codec: full encode/decode of the reference's tree file
// format (TreeBuilder.scala framing + tree.proto messages) — the Python
// proto codec is the bottleneck at million-item scale.
// ---------------------------------------------------------------------------

namespace {

inline void put_varint(std::string& out, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out.push_back(static_cast<char>(b | 0x80));
    } else {
      out.push_back(static_cast<char>(b));
      return;
    }
  }
}

inline void put_tag(std::string& out, int field, int wtype) {
  put_varint(out, (static_cast<uint64_t>(field) << 3) | wtype);
}

inline void put_len_delim(std::string& out, int field, const std::string& payload) {
  put_tag(out, field, 2);
  put_varint(out, payload.size());
  out += payload;
}

inline void put_float(std::string& out, int field, float v) {
  put_tag(out, field, 5);
  char buf[4];
  memcpy(buf, &v, 4);
  out.append(buf, 4);
}

std::string encode_node(int64_t id, float prob, bool is_leaf) {
  std::string out;
  if (id != 0) {
    put_tag(out, 1, 0);
    put_varint(out, static_cast<uint64_t>(id));
  }
  if (prob != 0.0f) put_float(out, 2, prob);
  if (is_leaf) {
    put_tag(out, 4, 0);
    put_varint(out, 1);
  }
  return out;
}

void write_kv(std::string& out, const std::string& key, const std::string& value) {
  std::string rec;
  put_len_delim(rec, 1, key);
  put_len_delim(rec, 2, value);
  uint32_t len = static_cast<uint32_t>(rec.size());
  char hdr[4] = {static_cast<char>(len >> 24), static_cast<char>(len >> 16),
                 static_cast<char>(len >> 8), static_cast<char>(len)};
  out.append(hdr, 4);
  out += rec;
}

inline uint64_t get_varint(const uint8_t*& p) {
  uint64_t v = 0;
  int shift = 0;
  while (true) {
    uint8_t b = *p++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return v;
    shift += 7;
  }
}

}  // namespace

// Write a full tree file.  Leaves: parallel arrays (item id, bottom-level
// code, prob), sorted by code by the caller.  Ancestors: (code, id, prob).
// part_size mirrors the 512-pair Part_i chunking; max_level for tree_meta.
extern "C" int64_t dm_write_tree(const char* path, int64_t n_leaves,
                                 const int64_t* leaf_ids,
                                 const int64_t* leaf_codes,
                                 const float* leaf_probs, int64_t n_anc,
                                 const int64_t* anc_codes,
                                 const int64_t* anc_ids,
                                 const float* anc_probs, int32_t max_level) {
  std::string out;
  out.reserve(static_cast<size_t>((n_leaves + n_anc) * 48));
  std::vector<std::string> parts;
  std::string cur_part;
  int64_t pairs_in_part = 0;

  // interleave leaves with first-seen ancestors like the reference writer;
  // ancestors are supplied pre-deduplicated, so just append them after their
  // first leaf is irrelevant — order of records does not matter to readers.
  for (int64_t i = 0; i < n_leaves; i++) {
    write_kv(out, std::to_string(leaf_codes[i]),
             encode_node(leaf_ids[i], leaf_probs[i], true));
    // IdCodePair into the current part
    std::string pair;
    if (leaf_ids[i] != 0) {
      put_tag(pair, 1, 0);
      put_varint(pair, static_cast<uint64_t>(leaf_ids[i]));
    }
    if (leaf_codes[i] != 0) {
      put_tag(pair, 2, 0);
      put_varint(pair, static_cast<uint64_t>(leaf_codes[i]));
    }
    put_len_delim(cur_part, 2, pair);
    pairs_in_part++;
    if (pairs_in_part == 512 || i == n_leaves - 1) {
      parts.push_back(std::move(cur_part));
      cur_part.clear();
      pairs_in_part = 0;
    }
  }
  for (int64_t i = 0; i < n_anc; i++) {
    write_kv(out, std::to_string(anc_codes[i]),
             encode_node(anc_ids[i], anc_probs[i], false));
  }
  std::string meta;
  if (max_level != 0) {
    put_tag(meta, 1, 0);
    put_varint(meta, static_cast<uint64_t>(max_level));
  }
  for (size_t pi = 0; pi < parts.size(); pi++) {
    std::string part_id = "Part_" + std::to_string(pi + 1);
    std::string part;
    put_len_delim(part, 1, part_id);
    part += parts[pi];
    write_kv(out, part_id, part);
    put_len_delim(meta, 2, part_id);
  }
  write_kv(out, "tree_meta", meta);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t written = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return written == out.size() ? static_cast<int64_t>(n_leaves + n_anc) : -1;
}

struct TreeDecodeResult {
  int32_t max_level;
  int64_t n_nodes;   // numeric-key records
  int64_t n_pairs;   // id/code pairs from Part_i records
  int64_t* node_codes;
  int64_t* node_ids;
  float* node_probs;
  uint8_t* node_is_leaf;
  int64_t* pair_ids;
  int64_t* pair_codes;
};

extern "C" TreeDecodeResult* dm_read_tree(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<int64_t> node_codes, node_ids, pair_ids, pair_codes;
  std::vector<float> node_probs;
  std::vector<uint8_t> node_leaf;
  int32_t max_level = 0;

  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf.data());
  const uint8_t* end = p + size;
  while (p + 4 <= end) {
    uint32_t rec_len = (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
    p += 4;
    if (p + rec_len > end) break;
    const uint8_t* rp = p;
    const uint8_t* rend = p + rec_len;
    p += rec_len;
    // KVItem: field 1 = key bytes, field 2 = value bytes
    const uint8_t* key = nullptr;
    size_t key_len = 0;
    const uint8_t* val = nullptr;
    size_t val_len = 0;
    while (rp < rend) {
      uint64_t tag = get_varint(rp);
      uint64_t len = get_varint(rp);
      if ((tag >> 3) == 1) {
        key = rp;
        key_len = len;
      } else if ((tag >> 3) == 2) {
        val = rp;
        val_len = len;
      }
      rp += len;
    }
    if (!key) continue;
    if (key_len >= 5 && memcmp(key, "Part_", 5) == 0) {
      // IdCodePart: field 2 repeated IdCodePair
      const uint8_t* vp = val;
      const uint8_t* vend = val + val_len;
      while (vp < vend) {
        uint64_t tag = get_varint(vp);
        int field = static_cast<int>(tag >> 3);
        int wt = static_cast<int>(tag & 7);
        if (wt == 2) {
          uint64_t len = get_varint(vp);
          if (field == 2) {
            const uint8_t* pp = vp;
            const uint8_t* pend = vp + len;
            int64_t pid = 0, pcode = 0;
            while (pp < pend) {
              uint64_t ptag = get_varint(pp);
              uint64_t pv = get_varint(pp);
              if ((ptag >> 3) == 1) pid = static_cast<int64_t>(pv);
              if ((ptag >> 3) == 2) pcode = static_cast<int64_t>(pv);
            }
            pair_ids.push_back(pid);
            pair_codes.push_back(pcode);
          }
          vp += len;
        } else {
          get_varint(vp);
        }
      }
    } else if (key_len == 9 && memcmp(key, "tree_meta", 9) == 0) {
      const uint8_t* vp = val;
      const uint8_t* vend = val + val_len;
      while (vp < vend) {
        uint64_t tag = get_varint(vp);
        int wt = static_cast<int>(tag & 7);
        if (wt == 0) {
          uint64_t v = get_varint(vp);
          if ((tag >> 3) == 1) max_level = static_cast<int32_t>(v);
        } else if (wt == 2) {
          uint64_t len = get_varint(vp);
          vp += len;
        }
      }
    } else {
      // numeric code key -> Node
      bool numeric = key_len > 0;
      for (size_t k = 0; k < key_len; k++) {
        if (key[k] < '0' || key[k] > '9') {
          numeric = false;
          break;
        }
      }
      if (!numeric) continue;
      int64_t code = strtoll(std::string(reinterpret_cast<const char*>(key),
                                         key_len).c_str(), nullptr, 10);
      const uint8_t* vp = val;
      const uint8_t* vend = val + val_len;
      int64_t nid = 0;
      float prob = 0.0f;
      uint8_t leaf = 0;
      while (vp < vend) {
        uint64_t tag = get_varint(vp);
        int field = static_cast<int>(tag >> 3);
        int wt = static_cast<int>(tag & 7);
        if (wt == 0) {
          uint64_t v = get_varint(vp);
          if (field == 1) nid = static_cast<int64_t>(static_cast<int32_t>(v));
          if (field == 4) leaf = v ? 1 : 0;
        } else if (wt == 5) {
          if (field == 2) memcpy(&prob, vp, 4);
          vp += 4;
        } else if (wt == 2) {
          uint64_t len = get_varint(vp);
          vp += len;
        }
      }
      node_codes.push_back(code);
      node_ids.push_back(nid);
      node_probs.push_back(prob);
      node_leaf.push_back(leaf);
    }
  }

  auto* res = new TreeDecodeResult();
  res->max_level = max_level;
  res->n_nodes = static_cast<int64_t>(node_codes.size());
  res->n_pairs = static_cast<int64_t>(pair_ids.size());
  res->node_codes = new int64_t[node_codes.size()];
  res->node_ids = new int64_t[node_ids.size()];
  res->node_probs = new float[node_probs.size()];
  res->node_is_leaf = new uint8_t[node_leaf.size()];
  res->pair_ids = new int64_t[pair_ids.size()];
  res->pair_codes = new int64_t[pair_codes.size()];
  memcpy(res->node_codes, node_codes.data(), node_codes.size() * 8);
  memcpy(res->node_ids, node_ids.data(), node_ids.size() * 8);
  memcpy(res->node_probs, node_probs.data(), node_probs.size() * 4);
  memcpy(res->node_is_leaf, node_leaf.data(), node_leaf.size());
  memcpy(res->pair_ids, pair_ids.data(), pair_ids.size() * 8);
  memcpy(res->pair_codes, pair_codes.data(), pair_codes.size() * 8);
  return res;
}

extern "C" void dm_free_tree(TreeDecodeResult* res) {
  if (!res) return;
  delete[] res->node_codes;
  delete[] res->node_ids;
  delete[] res->node_probs;
  delete[] res->node_is_leaf;
  delete[] res->pair_ids;
  delete[] res->pair_codes;
  delete res;
}

// ---------------------------------------------------------------------------
// DR coordinate-descent greedy path selection (train/dr_coordinate.py
// lines "greedy selection"; reference semantics: deep-retrieval/.../optim/
// CoordinateDescent.scala:50-83 — item-sequential streaming greedy with the
// incremental path-size penalty).
//
// Exact port of the Python/numpy loop: same float64 libm calls (log1p, pow),
// same processing order (row-ascending == item-ascending, items_u is
// sorted), same argmax semantics (numpy returns the FIRST NaN index when a
// NaN is present, else the first maximum), same NaN fallback (best-scored
// usable candidate).  On the same host this is bit-identical to the numpy
// loop (tests/test_torch_native.py) and replaces
// ~80s of 2M-iteration Python at a 1M-item catalog with ~1s of C++.
// ---------------------------------------------------------------------------

extern "C" void dm_dr_greedy_select(
    int64_t n_rows, int64_t j_paths, int64_t n_cand, int64_t num_iteration,
    const int64_t* cand_idx,    // [n_rows, n_cand] factorized path-key index
    const double* cand_scores,  // [n_rows, n_cand], -inf = invalid slot
    const int64_t* occ_rows,    // [n_rows] training occurrences per row
    int64_t* path_size,         // [n_keys] in/out
    int64_t* sel_idx,           // [n_rows, j_paths] in/out (-1 init)
    double penalty_factor, double q) {
  if (n_cand > 64 || n_cand <= 0) return;  // use[64] below; callers must
                                           // fall back for wider candidates
  std::vector<double> gains(n_cand);
  std::vector<int64_t> chosen(j_paths);
  const double neg_inf = -std::numeric_limits<double>::infinity();
  for (int64_t t = 1; t <= num_iteration; ++t) {
    for (int64_t r = 0; r < n_rows; ++r) {
      if (occ_rows[r] == 0) continue;  // random-path items stay in Python
      const double nv = static_cast<double>(occ_rows[r]);
      const int64_t* ci = cand_idx + r * n_cand;
      const double* sc = cand_scores + r * n_cand;
      double partial = 0.0;
      int64_t n_chosen = 0;
      for (int64_t j = 0; j < j_paths; ++j) {
        if (t > 1) path_size[sel_idx[r * j_paths + j]] -= 1;
        // use = valid & !already-chosen; fall back to valid when empty
        bool any_use = false;
        bool use[64];  // n_cand is the CLI's num_candidate_path (<= 64)
        for (int64_t c = 0; c < n_cand; ++c) {
          bool ok = sc[c] > neg_inf;
          bool dup = false;
          for (int64_t k = 0; k < n_chosen; ++k)
            if (chosen[k] == ci[c]) { dup = true; break; }
          use[c] = ok && !dup;
          any_use |= use[c];
        }
        if (!any_use)
          for (int64_t c = 0; c < n_cand; ++c) use[c] = sc[c] > neg_inf;
        const double base = log1p(partial);
        for (int64_t c = 0; c < n_cand; ++c) {
          if (!use[c]) { gains[c] = neg_inf; continue; }
          const double s = static_cast<double>(path_size[ci[c]]);
          const double pen =
              penalty_factor * (pow(s + 1.0, q) - pow(s, q)) / q;
          gains[c] = nv * (log1p(sc[c] + partial) - base) - pen;
        }
        // numpy argmax: first NaN wins, else first strict maximum
        int64_t b = 0;
        double bg = gains[0];
        if (!std::isnan(bg)) {
          for (int64_t c = 1; c < n_cand; ++c) {
            if (std::isnan(gains[c])) { b = c; break; }
            if (gains[c] > bg) { b = c; bg = gains[c]; }
          }
        }
        if (!std::isfinite(gains[b])) {
          // all gains NaN/-inf — keep the best-scored usable candidate
          b = 0;
          double bs = use[0] ? sc[0] : neg_inf;
          bool nan_hit = std::isnan(bs);
          if (!nan_hit) {
            for (int64_t c = 1; c < n_cand; ++c) {
              const double v = use[c] ? sc[c] : neg_inf;
              if (std::isnan(v)) { b = c; break; }
              if (v > bs) { b = c; bs = v; }
            }
          }
        }
        path_size[ci[b]] += 1;
        chosen[n_chosen++] = ci[b];
        partial += sc[b];
        sel_idx[r * j_paths + j] = ci[b];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Co-occurrence operator apply for spectral cluster features
// (index/cluster.cooccurrence_embeddings).  One power-iteration pass
// g[dst] += f[src] * wn over the dst-sorted deduped edge list.  The numpy
// form (f[src] * wn materializes an [E, dim] array, np.add.reduceat runs a
// scalar inner loop) dominated the 1M-item cooc stage at ~1300s; here the
// dst-sorted segments give each thread a DISJOINT output range, so the pass
// is embarrassingly parallel with no atomics and is bound by the random
// reads of f (cache-missing row gathers).
// ---------------------------------------------------------------------------

#include <thread>

extern "C" void dm_cooc_apply(
    int64_t n_seg, int64_t dim, int64_t n_threads,
    const int64_t* starts,  // [n_seg] first edge of each dst segment
    const int64_t* segs,    // [n_seg] dst row per segment
    int64_t n_edges,
    const int64_t* src,     // [n_edges] source row per edge
    const float* wn,        // [n_edges] normalized edge weight
    const float* f,         // [n_items, dim] input features
    float* g) {             // [n_items, dim] output (zeroed rows written)
  if (n_seg <= 0) return;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  // split SEGMENTS (not edges) so each thread's output rows are disjoint;
  // balance by cumulative edge count
  std::vector<int64_t> bounds(n_threads + 1, n_seg);
  bounds[0] = 0;
  for (int64_t t = 1; t < n_threads; ++t) {
    int64_t target = n_edges * t / n_threads;
    // first segment whose start >= target
    int64_t lo = bounds[t - 1], hi = n_seg;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (starts[mid] < target) lo = mid + 1; else hi = mid;
    }
    bounds[t] = lo;
  }
  auto work = [&](int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t e0 = starts[s];
      const int64_t e1 = (s + 1 < n_seg) ? starts[s + 1] : n_edges;
      float* out = g + segs[s] * dim;
      for (int64_t e = e0; e < e1; ++e) {
        const float* row = f + src[e] * dim;
        const float w = wn[e];
        for (int64_t d = 0; d < dim; ++d) out[d] += row[d] * w;
      }
    }
  };
  if (n_threads == 1) {
    work(0, n_seg);
    return;
  }
  for (int64_t t = 0; t < n_threads; ++t)
    pool.emplace_back(work, bounds[t], bounds[t + 1]);
  for (auto& th : pool) th.join();
}
