// Threaded svmlight/libsvm writer.
//
// Counterpart of libsvm_parser.cpp for the output direction: rank_and_click
// writes WEB30K-scale click datasets back to libsvm (reference:
// allrank/data/dataset_saving.py:9-32 via sklearn.dump_svmlight_file), a
// row at a time in Python there. This writer formats row ranges in parallel with std::to_chars (shortest round-trip
// float form, exact re-parse) into per-thread buffers and streams them to
// disk in order.
//
// Line grammar matches sklearn's default dump: zero-based feature indices,
// zero values omitted, `label qid:Q i:v i:v ...`.
//
// Base pinning: svmlight readers (sklearn's "auto" rule, mirrored by
// libsvm_parser.cpp) treat a file as ONE-based unless a 0 index appears
// somewhere — so a zero-based dump whose column 0 is entirely zero would
// be re-read with every column shifted left (a real sklearn dump/load
// footgun). When column 0 has no non-zero
// anywhere, this writer emits one explicit `0:0` on the first row: valid
// grammar, value unchanged, and the round-trip is unambiguous.
//
// Built at first use by allrank_tpu_torch/data/native.py
// (g++ -O3 -std=c++17 -shared -fPIC -pthread -Wall).

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline void append_num(std::string& out, float v) {
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr - buf);
}

inline void append_num(std::string& out, int64_t v) {
  char buf[24];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr - buf);
}

void format_rows(const float* X, const float* y, const int64_t* qid,
                 int64_t row_begin, int64_t row_end, int64_t n_feat,
                 bool pin_base, std::string& out) {
  out.reserve(static_cast<size_t>(row_end - row_begin) *
              static_cast<size_t>(n_feat) * 14u);
  for (int64_t r = row_begin; r < row_end; ++r) {
    append_num(out, y[r]);
    out += " qid:";
    append_num(out, qid[r]);
    if (pin_base && r == 0) out += " 0:0";
    const float* row = X + r * n_feat;
    for (int64_t j = 0; j < n_feat; ++j) {
      const float v = row[j];
      if (v == 0.0f) continue;  // sparse-format semantics (sklearn parity)
      out += ' ';
      append_num(out, j);
      out += ':';
      append_num(out, v);
    }
    out += '\n';
  }
}

}  // namespace

extern "C" int64_t write_svmlight(const float* X, const float* y,
                                  const int64_t* qid, int64_t n_rows,
                                  int64_t n_feat, const char* path,
                                  int64_t n_threads) {
  if (n_rows < 0 || n_feat <= 0) return 1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_rows && n_rows > 0) n_threads = n_rows;

  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return 2;

  // base pinning: does column 0 carry any non-zero?
  bool col0_used = false;
  for (int64_t r = 0; r < n_rows && !col0_used; ++r)
    col0_used = X[r * n_feat] != 0.0f;
  const bool pin_base = n_rows > 0 && !col0_used;

  // waves bound the formatted-text footprint: ~8 MB of buffer per thread
  // in flight regardless of the feature count (a fixed ROW count would
  // scale the footprint with n_feat — ~1 GB/wave at 136 dense features)
  const int64_t rows_per_thread =
      std::max<int64_t>(1024, (8 << 20) / (n_feat * 14));
  const int64_t wave = rows_per_thread * n_threads;
  std::vector<std::string> chunks(static_cast<size_t>(n_threads));
  for (int64_t wave_begin = 0; wave_begin < n_rows; wave_begin += wave) {
    const int64_t wave_end =
        wave_begin + wave < n_rows ? wave_begin + wave : n_rows;
    const int64_t per = (wave_end - wave_begin + n_threads - 1) / n_threads;
    std::vector<std::thread> workers;
    for (int64_t t = 0; t < n_threads; ++t) {
      const int64_t begin = wave_begin + t * per;
      const int64_t end = begin + per < wave_end ? begin + per : wave_end;
      chunks[static_cast<size_t>(t)].clear();
      if (begin >= end) continue;
      workers.emplace_back(format_rows, X, y, qid, begin, end, n_feat,
                           pin_base, std::ref(chunks[static_cast<size_t>(t)]));
    }
    for (auto& w : workers) w.join();
    for (const auto& c : chunks) {
      if (!c.empty() && std::fwrite(c.data(), 1, c.size(), f) != c.size()) {
        std::fclose(f);
        return 3;
      }
    }
  }
  if (std::fclose(f) != 0) return 3;
  return 0;
}
