// Native slate batch assembler — the host-side hot loop of training.
//
// Python assembly of fixed-shape [B, L, F] batches from per-query slates
// runs on one core and CANNOT use threads (GIL-bound small-op numpy). This assembler runs the same per-row work — zero-pad
// short slates, subsample/permute long ones with the relevance guard
// (reference semantics: allrank/data/dataset_loading.py:32-93) — in C++
// with real threads. The ctypes call releases the GIL, so assembly of
// batch t+1 also overlaps device compute of batch t.
//
// Randomness: a per-(seed, epoch, slate) splitmix64 stream drives the
// subsample draws, so assembled batches are deterministic and independent
// of process layout / thread count (the multi-host exactly-once contract).
// The draws differ numerically from the Python path's numpy RandomState —
// both are valid samplers of the same distribution.
//
// Built at first use by allrank_tpu_torch/data/native.py
// (g++ -O3 -std=c++17 -shared -fPIC -pthread -Wall).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality, seedable per slate
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  int64_t below(int64_t n) {
    return static_cast<int64_t>(next() % static_cast<uint64_t>(n));
  }
};

constexpr float kPaddedY = -1.0f;
constexpr int32_t kPaddedIdx = -1;

void fill_one(const float* X, const float* y, const int64_t* offsets,
              int64_t slate, int64_t rng_slate_id, int64_t F, int64_t L,
              uint64_t seed_base, float* out_x, float* out_y,
              int32_t* out_idx) {
  const int64_t start = offsets[slate];
  const int64_t n = offsets[slate + 1] - start;
  const float* Xs = X + start * F;
  const float* ys = y + start;

  if (n < L) {  // pad (reference _pad: dataset_loading.py:82-93)
    std::memcpy(out_x, Xs, sizeof(float) * n * F);
    std::memcpy(out_y, ys, sizeof(float) * n);
    for (int64_t d = 0; d < n; ++d) out_idx[d] = static_cast<int32_t>(d);
    // out buffers arrive pre-filled with zeros / padded values
    return;
  }

  // n >= L: subsample (or permute at n == L) with the relevance guard
  // (reference _sample: dataset_loading.py:61-79)
  Rng rng(seed_base ^ (0x9e3779b97f4a7c15ULL * static_cast<uint64_t>(rng_slate_id + 1)));

  double total = 0.0;
  int64_t argmax = 0;
  for (int64_t d = 0; d < n; ++d) {
    total += ys[d];
    if (ys[d] > ys[argmax]) argmax = d;
  }

  std::vector<int64_t> perm(n);
  std::vector<int64_t> sel(L);
  for (int attempt = 0; attempt < 64; ++attempt) {
    for (int64_t d = 0; d < n; ++d) perm[d] = d;
    // partial Fisher-Yates: first L entries are a uniform draw w/o replacement
    for (int64_t d = 0; d < L; ++d) {
      int64_t j = d + rng.below(n - d);
      std::swap(perm[d], perm[j]);
    }
    std::copy(perm.begin(), perm.begin() + L, sel.begin());
    if (total == 0.0) break;
    double picked = 0.0;
    for (int64_t d = 0; d < L; ++d) picked += ys[sel[d]];
    if (picked != 0.0) break;
    if (total == 1.0 || attempt == 62) {
      // keep-a-relevant guard: put the argmax at a random position
      sel[rng.below(L)] = argmax;
      break;
    }
    // total > 1: redraw
  }

  for (int64_t d = 0; d < L; ++d) {
    const int64_t src = sel[d];
    std::memcpy(out_x + d * F, Xs + src * F, sizeof(float) * F);
    out_y[d] = ys[src];
    out_idx[d] = static_cast<int32_t>(src);
  }
}

}  // namespace

extern "C" {

// Fills rows of a fixed-shape batch. Buffers must arrive pre-initialized
// (x zeros, y kPaddedY, idx kPaddedIdx, mask 0). Rows are independent; work
// is split across n_threads.
int64_t assemble_rows(const float* X, const float* y, const int64_t* offsets,
                      const int64_t* rows, const int64_t* slates,
                      const int64_t* rng_ids, int64_t n_todo, int64_t F,
                      int64_t L, uint64_t seed_base, int64_t n_threads,
                      float* out_x, float* out_y, int32_t* out_idx,
                      uint8_t* out_mask) {
  if (n_todo <= 0) return 0;
  n_threads = std::max<int64_t>(1, std::min(n_threads, n_todo));

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t t = lo; t < hi; ++t) {
      const int64_t row = rows[t];
      fill_one(X, y, offsets, slates[t], rng_ids[t], F, L, seed_base,
               out_x + row * L * F, out_y + row * L, out_idx + row * L);
      out_mask[row] = 1;
    }
  };

  if (n_threads == 1) {
    worker(0, n_todo);
    return n_todo;
  }
  std::vector<std::thread> threads;
  const int64_t span = (n_todo + n_threads - 1) / n_threads;
  for (int64_t i = 0; i < n_todo; i += span) {
    threads.emplace_back(worker, i, std::min(i + span, n_todo));
  }
  for (auto& th : threads) th.join();
  return n_todo;
}

}  // extern "C"
