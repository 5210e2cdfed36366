// Native columnar-JSON dataset writer.
//
// The framework's datagen produces fixed-size masked arrays on-device; the
// reference's dataset contract is a 13-key columnar JSON of ragged lists
// (OpenPyStruct_BeamOpt_training_SingleCore.py:73-87).  Converting 100k
// samples through per-sample Python loops + json.dump dominates end-to-end
// datagen wall-clock once the TPU side runs at ~8k samples/s, so the
// conversion/serialization runs here: multi-threaded, shortest-round-trip
// float formatting via std::to_chars (doubles, matching CPython's repr of
// float(np.float32) exactly).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC dataset_writer.cpp -o libopsio.so
// ABI: plain C, consumed through ctypes (no pybind11 in this image).

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline void append_double(std::string& out, double v) {
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr - buf);
}

inline void append_int(std::string& out, long v) {
  char buf[24];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr - buf);
}

struct Batch {
  int B;        // samples
  int n;        // nodes per sample
  const float* node_x;    // B*n
  const uint8_t* roller;  // B*n
  const float* loads;     // B*n
  const float* I;         // B*(n-1)
  const float* shear;     // B*(n-1)
  const float* moment;    // B*(n-1)
  const float* defl;      // B*n
  const float* rot;       // B*n
  const uint8_t* valid;   // B
  // optional draw-order ranks (B*n int32; >= n where unselected); when
  // given, roller/force lists are emitted in the reference's random draw
  // order (MultiCore.py:137-162) instead of ascending node order
  const int32_t* roller_order = nullptr;
  const int32_t* force_order = nullptr;
};

// Selected indices for one sample, ascending or by draw-order rank.
template <class Pred>
inline int ordered_idx(int n, const int32_t* order, Pred pred,
                       std::vector<int>& idx) {
  idx.clear();
  for (int i = 0; i < n; ++i)
    if (pred(i)) idx.push_back(i);
  if (order) {
    // insertion sort by rank; selected counts are tiny (<= a few)
    for (size_t a = 1; a < idx.size(); ++a) {
      int v = idx[a];
      int b = (int)a - 1;
      while (b >= 0 && order[idx[b]] > order[v]) {
        idx[b + 1] = idx[b];
        --b;
      }
      idx[b + 1] = v;
    }
  }
  return (int)idx.size();
}

// Append one sample's entry for a given column.
void sample_entry(const Batch& b, int key, int s, std::string& out) {
  const int n = b.n;
  const float* nx = b.node_x + (size_t)s * n;
  const uint8_t* rm = b.roller + (size_t)s * n;
  const float* ld = b.loads + (size_t)s * n;
  const int32_t* ro =
      b.roller_order ? b.roller_order + (size_t)s * n : nullptr;
  const int32_t* fo =
      b.force_order ? b.force_order + (size_t)s * n : nullptr;
  static thread_local std::vector<int> idx;
  auto rollers = [&]() {
    return ordered_idx(n, ro, [&](int i) { return rm[i] != 0; }, idx);
  };
  auto forces = [&]() {
    return ordered_idx(n, fo, [&](int i) { return ld[i] != 0.0f; }, idx);
  };
  out.push_back('[');
  bool first = true;
  auto sep = [&]() {
    if (!first) out.push_back(',');
    first = false;
  };
  switch (key) {
    case 0: {  // roller_x_locations
      int k = rollers();
      for (int j = 0; j < k; ++j) {
        sep(); append_double(out, (double)nx[idx[j]]);
      }
      break;
    }
    case 1: {  // force_x_locations
      int k = forces();
      for (int j = 0; j < k; ++j) {
        sep(); append_double(out, (double)nx[idx[j]]);
      }
      break;
    }
    case 2: {  // force_values
      int k = forces();
      for (int j = 0; j < k; ++j) {
        sep(); append_double(out, (double)ld[idx[j]]);
      }
      break;
    }
    case 3:  // I_values
      for (int i = 0; i < n - 1; ++i) {
        sep(); append_double(out, (double)b.I[(size_t)s * (n - 1) + i]);
      }
      break;
    case 4:  // shear_forces
      for (int i = 0; i < n - 1; ++i) {
        sep(); append_double(out, (double)b.shear[(size_t)s * (n - 1) + i]);
      }
      break;
    case 5:  // bending_moments
      for (int i = 0; i < n - 1; ++i) {
        sep(); append_double(out, (double)b.moment[(size_t)s * (n - 1) + i]);
      }
      break;
    case 6:  // node_positions
      for (int i = 0; i < n; ++i) { sep(); append_double(out, (double)nx[i]); }
      break;
    case 7: {  // roller_nodes (1-based tags, MultiCore.py:227-240)
      int k = rollers();
      for (int j = 0; j < k; ++j) { sep(); append_int(out, idx[j] + 1); }
      break;
    }
    case 8: {  // force_nodes
      int k = forces();
      for (int j = 0; j < k; ++j) { sep(); append_int(out, idx[j] + 1); }
      break;
    }
    case 11:  // rotations
      for (int i = 0; i < n; ++i) {
        sep(); append_double(out, (double)b.rot[(size_t)s * n + i]);
      }
      break;
    case 12:  // deflections
      for (int i = 0; i < n; ++i) {
        sep(); append_double(out, (double)b.defl[(size_t)s * n + i]);
      }
      break;
  }
  out.push_back(']');
}

const char* kKeys[13] = {
    "roller_x_locations", "force_x_locations", "force_values", "I_values",
    "shear_forces", "bending_moments", "node_positions", "roller_nodes",
    "force_nodes", "num_nodes", "L", "rotations", "deflections"};

// Render every column of the kept samples into per-shard strings:
// parts[key][shard].  Shared by the one-shot writer and the chunked
// (streaming) appender.
void render_columns(const Batch& b, const std::vector<int>& keep,
                    int num_threads,
                    std::vector<std::vector<std::string>>& parts) {
  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  const int kept = (int)keep.size();
  const int shards = std::min(num_threads, std::max(kept, 1));
  parts.assign(13, std::vector<std::string>(shards));

  auto work = [&](int shard) {
    int lo = (int)((long)kept * shard / shards);
    int hi = (int)((long)kept * (shard + 1) / shards);
    for (int key = 0; key < 13; ++key) {
      if (key == 9 || key == 10) continue;  // scalars handled below
      std::string& out = parts[key][shard];
      out.reserve((size_t)(hi - lo) * 12 * b.n);
      for (int idx = lo; idx < hi; ++idx) {
        if (idx > lo) out.push_back(',');
        sample_entry(b, key, keep[idx], out);
      }
    }
    // scalar columns: num_nodes and L
    std::string& out = parts[9][shard];
    for (int idx = lo; idx < hi; ++idx) {
      if (idx > lo) out.push_back(',');
      append_int(out, b.n);
    }
    std::string& outL = parts[10][shard];
    for (int idx = lo; idx < hi; ++idx) {
      if (idx > lo) outL.push_back(',');
      append_double(outL, (double)b.node_x[(size_t)keep[idx] * b.n + b.n - 1]);
    }
  };

  std::vector<std::thread> pool;
  for (int t = 1; t < shards; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
}

std::string part_path(const char* dir, int key) {
  char buf[32];
  std::snprintf(buf, sizeof(buf), "/col_%02d.part", key);
  return std::string(dir) + buf;
}

}  // namespace

extern "C" {

// Serialize the batch to the 13-key columnar JSON at `path`, dropping
// samples where valid == 0.  Returns the number of samples written, or a
// negative errno-style code on failure.
int opsio_write_json_dataset(const char* path, int B, int n,
                             const float* node_x, const uint8_t* roller,
                             const float* loads, const float* I,
                             const float* shear, const float* moment,
                             const float* defl, const float* rot,
                             const uint8_t* valid,
                             const int32_t* roller_order,
                             const int32_t* force_order, int num_threads) {
  Batch b{B, n, node_x, roller, loads, I, shear, moment, defl, rot, valid,
          roller_order, force_order};
  std::vector<int> keep;
  keep.reserve(B);
  for (int s = 0; s < B; ++s)
    if (!valid || valid[s]) keep.push_back(s);

  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  const int kept = (int)keep.size();
  std::vector<std::vector<std::string>> parts;
  render_columns(b, keep, num_threads, parts);
  const int shards = (int)parts[0].size();

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fputc('{', f);
  for (int key = 0; key < 13; ++key) {
    if (key) std::fputc(',', f);
    std::fprintf(f, "\"%s\":[", kKeys[key]);
    for (int t = 0; t < shards; ++t) {
      const std::string& p = parts[key][t];
      if (t && !p.empty() && !parts[key][t - 1].empty()) std::fputc(',', f);
      if (!p.empty()) std::fwrite(p.data(), 1, p.size(), f);
    }
    std::fputc(']', f);
  }
  std::fputc('}', f);
  if (std::fclose(f) != 0) return -2;
  return kept;
}

// Streaming variant: append one batch's rendered columns to 13 per-key
// fragment files under `dir` (created by the caller).  `need_comma` is
// nonzero when samples were already appended (the caller tracks the running
// total).  Peak memory is one batch, not the whole dataset.  Returns the
// number of samples appended, or a negative code on failure.
int opsio_append_json_chunk(const char* dir, int B, int n,
                            const float* node_x, const uint8_t* roller,
                            const float* loads, const float* I,
                            const float* shear, const float* moment,
                            const float* defl, const float* rot,
                            const uint8_t* valid,
                            const int32_t* roller_order,
                            const int32_t* force_order, int need_comma,
                            int num_threads) {
  Batch b{B, n, node_x, roller, loads, I, shear, moment, defl, rot, valid,
          roller_order, force_order};
  std::vector<int> keep;
  keep.reserve(B);
  for (int s = 0; s < B; ++s)
    if (!valid || valid[s]) keep.push_back(s);
  if (keep.empty()) return 0;

  std::vector<std::vector<std::string>> parts;
  render_columns(b, keep, num_threads, parts);

  for (int key = 0; key < 13; ++key) {
    FILE* f = std::fopen(part_path(dir, key).c_str(), "ab");
    if (!f) return -1;
    bool wrote_any = false;
    for (auto& p : parts[key]) {
      if (p.empty()) continue;
      if (need_comma || wrote_any) std::fputc(',', f);
      wrote_any = true;
      std::fwrite(p.data(), 1, p.size(), f);
    }
    if (std::fclose(f) != 0) return -2;
  }
  return (int)keep.size();
}

// Stitch the 13 fragment files under `dir` into the final JSON document at
// `path` and remove the fragments.  Missing fragments are treated as empty
// columns (a zero-sample dataset).  Returns 0, or a negative code.
int opsio_finalize_json(const char* dir, const char* path) {
  FILE* out = std::fopen(path, "wb");
  if (!out) return -1;
  std::fputc('{', out);
  std::vector<char> buf(1 << 20);
  for (int key = 0; key < 13; ++key) {
    if (key) std::fputc(',', out);
    std::fprintf(out, "\"%s\":[", kKeys[key]);
    std::string pp = part_path(dir, key);
    FILE* in = std::fopen(pp.c_str(), "rb");
    if (in) {
      size_t got;
      while ((got = std::fread(buf.data(), 1, buf.size(), in)) > 0)
        std::fwrite(buf.data(), 1, got, out);
      std::fclose(in);
      std::remove(pp.c_str());
    }
    std::fputc(']', out);
  }
  std::fputc('}', out);
  if (std::fclose(out) != 0) return -2;
  return 0;
}

}  // extern "C"
