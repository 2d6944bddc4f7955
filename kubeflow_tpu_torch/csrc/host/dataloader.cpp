// Host-side prefetching token data-loader: the port's own copy of
// native/dataloader.cpp, built with g++ (not nvcc) by
// kubeflow_tpu_torch/ops/_build.py's build_host.
//
// Training is device-bound; the host's only job on the data path is to
// have the next (batch, seq) int32 window ready before the device asks.
// This loader mmaps a binary uint32 token corpus and assembles randomly
// sampled batches on a background thread into a bounded queue, so batch
// assembly overlaps device compute.
//
// C ABI (consumed via ctypes from kubeflow_tpu_torch/data/loader.py):
//   dl_open(path, batch, seq, seed, prefetch, start_batch)
//           -> opaque handle (NULL on error); start_batch fast-forwards
//              the sample stream by that many batches (checkpoint resume
//              must not re-read the batches the lost run already
//              consumed — O(log n) GF(2) matrix jump, mirroring the
//              Python fallback's _xorshift_skip bit-for-bit)
//   dl_num_tokens(h) -> corpus size in tokens
//   dl_next(h, out)  -> fills batch*seq int32s; 0 on success
//   dl_close(h)
//
// Determinism: one producer thread + a fixed-seed xorshift64* stream means
// the batch sequence is a pure function of (corpus, batch, seq, seed).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  const uint32_t* tokens = nullptr;
  size_t n_tokens = 0;
  size_t map_len = 0;
  int fd = -1;
  int batch = 0;
  int seq = 0;
  uint64_t rng = 0;
  size_t capacity = 0;

  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::deque<std::vector<int32_t>> queue;
  std::atomic<bool> stop{false};
  std::thread producer;

  uint64_t next_rand() {
    // xorshift64*
    rng ^= rng >> 12;
    rng ^= rng << 25;
    rng ^= rng >> 27;
    return rng * 0x2545F4914F6CDD1DULL;
  }

  void produce() {
    while (!stop.load(std::memory_order_relaxed)) {
      std::vector<int32_t> buf(static_cast<size_t>(batch) * seq);
      const size_t max_start = n_tokens - static_cast<size_t>(seq);
      for (int b = 0; b < batch; ++b) {
        const size_t start = next_rand() % (max_start + 1);
        std::memcpy(buf.data() + static_cast<size_t>(b) * seq,
                    tokens + start, static_cast<size_t>(seq) * sizeof(int32_t));
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_full.wait(lock, [this] { return queue.size() < capacity || stop; });
      if (stop) return;
      queue.push_back(std::move(buf));
      cv_empty.notify_one();
    }
  }
};

// One xorshift64 state transition (the output multiply does not feed the
// state, so resume-skip only needs this part).
uint64_t xs_step(uint64_t x) {
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  return x;
}

// The transition is linear over GF(2); column i of its matrix is the image
// of basis state 1<<i. Applying a matrix is then an XOR-fold of the columns
// selected by the state's set bits.
uint64_t xs_apply(const uint64_t* col, uint64_t x) {
  uint64_t y = 0;
  while (x) {
    y ^= col[__builtin_ctzll(x)];
    x &= x - 1;
  }
  return y;
}

// Advance by n transitions in O(log n) square-and-multiply — bit-identical
// to n sequential xs_step calls (the Python side cross-checks), but a
// resume at batch 1e8 costs ~64 squarings instead of stalling dl_open for
// minutes inside an O(n) loop.
uint64_t xs_jump(uint64_t state, uint64_t n) {
  uint64_t m[64], sq[64];
  for (int i = 0; i < 64; ++i) m[i] = xs_step(1ULL << i);
  while (n) {
    if (n & 1) state = xs_apply(m, state);
    for (int i = 0; i < 64; ++i) sq[i] = xs_apply(m, m[i]);
    std::memcpy(m, sq, sizeof m);
    n >>= 1;
  }
  return state;
}

}  // namespace

extern "C" {

// Must match loader.py _ABI_VERSION: the Python side refuses a library
// whose ABI does not match.
int dl_abi_version() { return 2; }

void* dl_open(const char* path, int batch, int seq, uint64_t seed,
              int prefetch, uint64_t start_batch) {
  if (batch <= 0 || seq <= 0 || prefetch <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(seq) * 4) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* h = new Loader();
  h->tokens = static_cast<const uint32_t*>(map);
  h->n_tokens = static_cast<size_t>(st.st_size) / 4;
  h->map_len = st.st_size;
  h->fd = fd;
  h->batch = batch;
  h->seq = seq;
  h->rng = seed ? seed : 0x9E3779B97F4A7C15ULL;
  // Resume skip: O(log n) jump over the skipped draws. The Python caller
  // rejects negative start_batch before it can wrap through c_uint64.
  h->rng = xs_jump(h->rng, start_batch * static_cast<uint64_t>(batch));
  h->capacity = prefetch;
  h->producer = std::thread([h] { h->produce(); });
  return h;
}

long dl_num_tokens(void* handle) {
  return handle ? static_cast<long>(static_cast<Loader*>(handle)->n_tokens) : -1;
}

int dl_next(void* handle, int32_t* out) {
  if (!handle || !out) return 1;
  auto* h = static_cast<Loader*>(handle);
  std::vector<int32_t> buf;
  {
    std::unique_lock<std::mutex> lock(h->mu);
    h->cv_empty.wait(lock, [h] { return !h->queue.empty() || h->stop; });
    if (h->queue.empty()) return 1;
    buf = std::move(h->queue.front());
    h->queue.pop_front();
    h->cv_full.notify_one();
  }
  std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
  return 0;
}

void dl_close(void* handle) {
  if (!handle) return;
  auto* h = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(h->mu);
    h->stop = true;
  }
  h->cv_full.notify_all();
  h->cv_empty.notify_all();
  if (h->producer.joinable()) h->producer.join();
  ::munmap(const_cast<uint32_t*>(h->tokens), h->map_len);
  ::close(h->fd);
  delete h;
}

}  // extern "C"
