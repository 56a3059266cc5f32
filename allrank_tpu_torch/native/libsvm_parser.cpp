// Fast multithreaded svmlight/libsvm parser for slate datasets.
//
// The data path's host-side hot spot on multi-GB MSLR-style files. Exposed to
// Python through a minimal two-pass C ABI (see allrank_tpu_torch/data/native.py):
//
//   parse_svmlight_count(path, &n_rows, &n_features) -> 0 on success
//   parse_svmlight_fill(path, n_rows, n_features, X, y, qids) -> 0 on success
//
// Semantics match sklearn.datasets.load_svmlight_file(query_id=True) with
// dense output: feature indices are auto-detected as 0- or 1-based (1-based
// unless a 0 index appears anywhere, the sklearn "auto" rule); missing
// entries are 0; lines may carry '#' comments; blank lines are skipped.
//
// Built at first use by allrank_tpu_torch/data/native.py
// (g++ -O3 -std=c++17 -shared -fPIC -pthread -Wall); needs std::from_chars for
// floats (GCC >= 11).

#include <atomic>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = "";
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data && size) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Chunk boundaries aligned to newlines so each thread owns whole lines.
std::vector<std::pair<const char*, const char*>> make_chunks(
    const char* data, size_t size, int n_threads) {
  std::vector<std::pair<const char*, const char*>> chunks;
  const char* end = data + size;
  const char* start = data;
  size_t per = size / static_cast<size_t>(n_threads) + 1;
  for (int t = 0; t < n_threads && start < end; ++t) {
    const char* stop = start + per;
    if (stop >= end) {
      stop = end;
    } else {
      const char* nl =
          static_cast<const char*>(memchr(stop, '\n', static_cast<size_t>(end - stop)));
      stop = nl ? nl + 1 : end;
    }
    chunks.emplace_back(start, stop);
    start = stop;
  }
  return chunks;
}

struct LineStats {
  int64_t rows = 0;
  int64_t max_index = -1;
  int64_t min_index = INT64_MAX;
  bool error = false;
};

// Per-line layout: label [qid:Q] idx:val idx:val ... [# comment]
template <typename OnRow>
bool parse_chunk(const char* p, const char* end, OnRow&& on_row) {
  while (p < end) {
    const char* nl =
        static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    const char* next = nl ? nl + 1 : end;

    // strip comment
    const char* hash =
        static_cast<const char*>(memchr(p, '#', static_cast<size_t>(line_end - p)));
    if (hash) line_end = hash;

    p = skip_ws(p, line_end);
    if (p >= line_end) {  // blank line
      p = next;
      continue;
    }
    if (!on_row(p, line_end)) return false;
    p = next;
  }
  return true;
}

inline bool parse_float(const char*& p, const char* end, float* out) {
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) return false;
  p = res.ptr;
  return true;
}

inline bool parse_i64(const char*& p, const char* end, int64_t* out) {
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) return false;
  p = res.ptr;
  return true;
}

int n_threads_for(size_t size) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  // small files: thread spawn overhead dominates
  if (size < (1u << 20)) return 1;
  return static_cast<int>(hw);
}

}  // namespace

extern "C" {

// Pass 1: count rows and find the feature-index range.
int64_t parse_svmlight_count(const char* path, int64_t* n_rows,
                             int64_t* n_features) {
  MappedFile f;
  if (!f.open_file(path)) return 1;

  int nt = n_threads_for(f.size);
  auto chunks = make_chunks(f.data, f.size, nt);
  std::vector<LineStats> stats(chunks.size());
  std::vector<std::thread> threads;

  for (size_t t = 0; t < chunks.size(); ++t) {
    threads.emplace_back([&, t]() {
      LineStats& s = stats[t];
      bool ok = parse_chunk(
          chunks[t].first, chunks[t].second,
          [&](const char* p, const char* lend) -> bool {
            float label;
            if (!parse_float(p, lend, &label)) return false;
            ++s.rows;
            while (true) {
              p = skip_ws(p, lend);
              if (p >= lend) break;
              if (lend - p >= 4 && memcmp(p, "qid:", 4) == 0) {
                p += 4;
                int64_t q;
                if (!parse_i64(p, lend, &q)) return false;
                continue;
              }
              int64_t idx;
              if (!parse_i64(p, lend, &idx)) return false;
              if (p >= lend || *p != ':') return false;
              ++p;
              float v;
              if (!parse_float(p, lend, &v)) return false;
              if (idx > s.max_index) s.max_index = idx;
              if (idx < s.min_index) s.min_index = idx;
            }
            return true;
          });
      if (!ok) s.error = true;
    });
  }
  for (auto& th : threads) th.join();

  int64_t rows = 0, max_index = -1, min_index = INT64_MAX;
  for (const auto& s : stats) {
    if (s.error) return 2;
    rows += s.rows;
    if (s.max_index > max_index) max_index = s.max_index;
    if (s.min_index < min_index) min_index = s.min_index;
  }
  if (rows == 0 || max_index < 0) return 3;
  // sklearn "auto" rule: one-based unless a zero index is present
  int64_t offset = (min_index == 0) ? 0 : 1;
  *n_rows = rows;
  *n_features = max_index - offset + 1;
  return 0;
}

// Pass 2: fill the caller-allocated dense buffers.
int64_t parse_svmlight_fill(const char* path, int64_t n_rows,
                            int64_t n_features, float* X, float* y,
                            int64_t* qids) {
  MappedFile f;
  if (!f.open_file(path)) return 1;

  int nt = n_threads_for(f.size);
  auto chunks = make_chunks(f.data, f.size, nt);

  // per-chunk row counts -> starting row of each chunk
  std::vector<int64_t> chunk_rows(chunks.size(), 0);
  std::vector<std::thread> counters;
  for (size_t t = 0; t < chunks.size(); ++t) {
    counters.emplace_back([&, t]() {
      int64_t rows = 0;
      parse_chunk(chunks[t].first, chunks[t].second,
                  [&](const char*, const char*) -> bool {
                    ++rows;
                    return true;
                  });
      chunk_rows[t] = rows;
    });
  }
  for (auto& th : counters) th.join();

  std::vector<int64_t> row_start(chunks.size() + 1, 0);
  for (size_t t = 0; t < chunks.size(); ++t)
    row_start[t + 1] = row_start[t] + chunk_rows[t];
  if (row_start.back() != n_rows) return 4;

  // index base must be re-detected (same rule as the count pass)
  std::atomic<bool> saw_zero{false};
  std::atomic<bool> failed{false};

  // detect zero-based indices quickly on chunk 0 is not sufficient — a zero
  // index can appear anywhere. Detect during the main fill with one-based
  // assumed, then re-fill if the assumption was wrong (rare: only files that
  // mix bases get two passes).
  auto fill_pass = [&](int64_t offset) {
    std::vector<std::thread> threads;
    for (size_t t = 0; t < chunks.size(); ++t) {
      threads.emplace_back([&, t, offset]() {
        int64_t row = row_start[t];
        bool ok = parse_chunk(
            chunks[t].first, chunks[t].second,
            [&](const char* p, const char* lend) -> bool {
              float label;
              if (!parse_float(p, lend, &label)) return false;
              if (row >= n_rows) return false;
              y[row] = label;
              int64_t qid = 0;
              float* xrow = X + row * n_features;
              while (true) {
                p = skip_ws(p, lend);
                if (p >= lend) break;
                if (lend - p >= 4 && memcmp(p, "qid:", 4) == 0) {
                  p += 4;
                  if (!parse_i64(p, lend, &qid)) return false;
                  continue;
                }
                int64_t idx;
                if (!parse_i64(p, lend, &idx)) return false;
                if (p >= lend || *p != ':') return false;
                ++p;
                float v;
                if (!parse_float(p, lend, &v)) return false;
                if (idx == 0) saw_zero.store(true, std::memory_order_relaxed);
                int64_t col = idx - offset;
                if (col < 0 || col >= n_features) {
                  // tolerated during the assumed-one-based probe pass; the
                  // zero-based re-fill will place it
                  if (idx != 0) return false;
                } else {
                  xrow[col] = v;
                }
              }
              qids[row] = qid;
              ++row;
              return true;
            });
        if (!ok) failed.store(true, std::memory_order_relaxed);
      });
    }
    for (auto& th : threads) th.join();
  };

  fill_pass(1);
  if (saw_zero.load()) {
    // zero-based file: redo with offset 0 over zeroed buffers
    memset(X, 0, static_cast<size_t>(n_rows) * n_features * sizeof(float));
    failed.store(false);
    fill_pass(0);
  }
  return failed.load() ? 2 : 0;
}

}  // extern "C"
