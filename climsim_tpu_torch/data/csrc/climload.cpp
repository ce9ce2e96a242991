// climload: native data-loader runtime for climsim_tpu.
//
// Replaces the reference's torch DataLoader worker processes
// (train_unet_h5loader.py:132-140, num_workers=16) with an in-process
// C++ engine: .npy shards are memory-mapped, batch rows are gathered by a
// thread pool into pinned-style contiguous buffers, and a background
// producer keeps a ring of ready batches ahead of the consumer.  The
// Python side (climsim_tpu/data/native.py) binds via ctypes and feeds
// jax.device_put directly from the returned buffers.
//
// Build: make -C runtime   (g++ -O3 -shared -fPIC -pthread)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyArray {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const float* data = nullptr;  // row-major float32
  int64_t rows = 0;
  int64_t cols = 0;
};

// Minimal .npy v1/v2 header parser for C-order float32/float64 2-D arrays.
bool open_npy(const char* path, NpyArray* a) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return false; }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) { ::close(fd); return false; }
  const unsigned char* p = static_cast<const unsigned char*>(m);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    munmap(m, st.st_size); ::close(fd); return false;
  }
  int major = p[6];
  size_t hlen, hstart;
  if (major == 1) {
    hlen = p[8] | (p[9] << 8);
    hstart = 10;
  } else {
    hlen = p[8] | (p[9] << 8) | (p[10] << 16) |
           (static_cast<size_t>(p[11]) << 24);
    hstart = 12;
  }
  std::string header(reinterpret_cast<const char*>(p) + hstart, hlen);
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    munmap(m, st.st_size); ::close(fd); return false;  // float32 C-order only
  }
  size_t sp = header.find("'shape':");
  size_t l = header.find('(', sp), r = header.find(')', sp);
  if (l == std::string::npos || r == std::string::npos) {
    munmap(m, st.st_size); ::close(fd); return false;
  }
  std::string shape = header.substr(l + 1, r - l - 1);
  long long rows = 0, cols = 0;
  if (sscanf(shape.c_str(), "%lld, %lld", &rows, &cols) != 2) {
    munmap(m, st.st_size); ::close(fd); return false;
  }
  a->fd = fd;
  a->map = m;
  a->map_size = st.st_size;
  a->data = reinterpret_cast<const float*>(p + hstart + hlen);
  a->rows = rows;
  a->cols = cols;
  // advise the kernel we'll touch this randomly but repeatedly
  madvise(m, st.st_size, MADV_WILLNEED);
  return true;
}

void close_npy(NpyArray* a) {
  if (a->map) munmap(a->map, a->map_size);
  if (a->fd >= 0) ::close(a->fd);
  a->map = nullptr;
  a->fd = -1;
}

struct Batch {
  std::vector<float> x;
  std::vector<float> y;
  int n = 0;
};

struct Loader {
  NpyArray xs, ys;
  int batch = 0;
  int nthreads = 4;

  // epoch state
  std::vector<int64_t> order;
  std::atomic<int64_t> next_batch_idx{0};
  int64_t num_batches = 0;

  // prefetch ring
  std::vector<Batch> ring;
  std::vector<std::atomic<int>> ring_state;  // 0 empty, 1 full
  size_t ring_size = 0;
  int64_t cons_seq = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_empty.notify_all();
    cv_full.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  void gather(const int64_t* idx, int n, float* ox, float* oy) const {
    const int64_t dx = xs.cols, dy = ys.cols;
    int nt = std::min<int>(nthreads, std::max(1, n / 64));
    auto work = [&](int t0) {
      for (int i = t0; i < n; i += nt) {
        memcpy(ox + i * dx, xs.data + idx[i] * dx, dx * sizeof(float));
        memcpy(oy + i * dy, ys.data + idx[i] * dy, dy * sizeof(float));
      }
    };
    if (nt <= 1) {
      work(0);
      return;
    }
    std::vector<std::thread> ts;
    for (int t = 1; t < nt; ++t) ts.emplace_back(work, t);
    work(0);
    for (auto& t : ts) t.join();
  }

  void producer_loop() {
    const int64_t dx = xs.cols, dy = ys.cols;
    while (!stop.load()) {
      int64_t b = next_batch_idx.fetch_add(1);
      if (b >= num_batches) break;
      size_t slot = b % ring_size;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_empty.wait(lk, [&] {
          return stop.load() ||
                 (ring_state[slot].load() == 0 && b < cons_seq + (int64_t)ring_size);
        });
        if (stop.load()) break;
      }
      Batch& bt = ring[slot];
      bt.n = batch;
      bt.x.resize(batch * dx);
      bt.y.resize(batch * dy);
      const int64_t* idx = order.data() + b * batch;
      for (int i = 0; i < batch; ++i) {
        memcpy(bt.x.data() + i * dx, xs.data + idx[i] * dx,
               dx * sizeof(float));
        memcpy(bt.y.data() + i * dy, ys.data + idx[i] * dy,
               dy * sizeof(float));
      }
      ring_state[slot].store(1);
      cv_full.notify_all();
    }
  }

  void start_epoch(uint64_t seed, int batch_size, int threads,
                   size_t ring_slots, bool shuffle) {
    shutdown();
    stop.store(false);
    batch = batch_size;
    nthreads = threads;
    order.resize(xs.rows);
    for (int64_t i = 0; i < xs.rows; ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed);
      for (int64_t i = xs.rows - 1; i > 0; --i) {
        int64_t j = rng() % (i + 1);
        std::swap(order[i], order[j]);
      }
    }
    num_batches = xs.rows / batch;
    next_batch_idx.store(0);
    cons_seq = 0;
    ring_size = ring_slots;
    ring.assign(ring_size, Batch());
    ring_state = std::vector<std::atomic<int>>(ring_size);
    for (auto& s : ring_state) s.store(0);
    for (int t = 0; t < threads; ++t)
      workers.emplace_back(&Loader::producer_loop, this);
  }

  // returns batch size, or 0 at end of epoch
  int next(float* ox, float* oy) {
    if (cons_seq >= num_batches) return 0;
    size_t slot = cons_seq % ring_size;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return stop.load() ||
                                    ring_state[slot].load() == 1; });
      if (stop.load() && ring_state[slot].load() != 1) return 0;
    }
    Batch& bt = ring[slot];
    memcpy(ox, bt.x.data(), bt.x.size() * sizeof(float));
    memcpy(oy, bt.y.data(), bt.y.size() * sizeof(float));
    int n = bt.n;
    ring_state[slot].store(0);
    {
      std::lock_guard<std::mutex> lk(mu);
      ++cons_seq;
    }
    cv_empty.notify_all();
    return n;
  }
};

}  // namespace

extern "C" {

void* climload_open(const char* x_path, const char* y_path) {
  auto* l = new Loader();
  if (!open_npy(x_path, &l->xs) || !open_npy(y_path, &l->ys) ||
      l->xs.rows != l->ys.rows) {
    close_npy(&l->xs);
    close_npy(&l->ys);
    delete l;
    return nullptr;
  }
  return l;
}

void climload_dims(void* h, int64_t* n, int64_t* dx, int64_t* dy) {
  auto* l = static_cast<Loader*>(h);
  *n = l->xs.rows;
  *dx = l->xs.cols;
  *dy = l->ys.cols;
}

void climload_gather(void* h, const int64_t* idx, int n, float* ox,
                     float* oy) {
  static_cast<Loader*>(h)->gather(idx, n, ox, oy);
}

void climload_start_epoch(void* h, uint64_t seed, int batch, int threads,
                          int ring, int shuffle) {
  static_cast<Loader*>(h)->start_epoch(seed, batch, threads,
                                       static_cast<size_t>(ring),
                                       shuffle != 0);
}

int climload_next(void* h, float* ox, float* oy) {
  return static_cast<Loader*>(h)->next(ox, oy);
}

void climload_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
