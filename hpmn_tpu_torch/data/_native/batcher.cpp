// Native batch-assembly core: multithreaded row gather for the DataLoader.
//
// Reference equivalent: the feed_dict batching loader (SURVEY.md §2.1 "Data
// loader"). Rationale for going native: assembling one XLong training batch
// (B=512, four [B,1000] int32 sequence fields + scalars, ~8 MB) costs
// ~4.7 ms of single-threaded numpy fancy indexing — a ~110k examples/s
// ceiling per host. One chip trains at ~31k ex/s so a single host feeding
// 4+ chips (the multi-host DP layout, SURVEY.md §5.8) would saturate the
// Python path; this pool-threaded gather lifts the host-side ceiling
// (measured in tools/bench_loader.py) while numpy stays as the always-on
// fallback (data/native_batcher.py).
//
// Interface (C, for ctypes): one call gathers B rows for all fields of a
// batch, so the thread pool is paid once per batch. Threads are a lazy
// persistent pool sized to the hardware; ctypes releases the GIL for the
// call's duration, so other Python threads (e.g. a serving daemon's
// handlers) keep running while a gather is in flight.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

class Pool {
 public:
  static Pool& instance() {
    static Pool pool;
    return pool;
  }

  int size() const { return static_cast<int>(workers_.size()); }

  // Run fn(chunk_index) for chunks [0, n_chunks); blocks until all done.
  // Concurrent callers serialize on call_mu_: ctypes releases the GIL for
  // batcher_gather, so two Python threads can reach here at once, and the
  // per-call scheduling state (fn_/next_chunk_/pending_) is single-job.
  void run(int n_chunks, const std::function<void(int)>& fn) {
    if (n_chunks <= 1 || workers_.empty()) {
      for (int c = 0; c < n_chunks; ++c) fn(c);
      return;
    }
    std::lock_guard<std::mutex> call_lock(call_mu_);
    {
      std::unique_lock<std::mutex> lk(mu_);
      fn_ = &fn;
      next_chunk_ = 0;
      n_chunks_ = n_chunks;
      pending_ = n_chunks;
      ++generation_;
    }
    cv_work_.notify_all();
    work_loop();  // the caller is a worker too
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [&] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  Pool() {
    unsigned n = std::thread::hardware_concurrency();
    int spares = n > 1 ? static_cast<int>(n) - 1 : 0;  // caller participates
    for (int i = 0; i < spares; ++i)
      workers_.emplace_back([this] { worker_entry(); });
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void worker_entry() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] { return stop_ || generation_ != seen; });
        if (stop_) return;
        seen = generation_;
      }
      work_loop();
    }
  }

  void work_loop() {
    for (;;) {
      int c;
      const std::function<void(int)>* fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (fn_ == nullptr || next_chunk_ >= n_chunks_) return;
        c = next_chunk_++;
        fn = fn_;
      }
      (*fn)(c);
      std::unique_lock<std::mutex> lk(mu_);
      if (--pending_ == 0) cv_done_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex call_mu_;  // serializes whole run() calls
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  const std::function<void(int)>* fn_ = nullptr;
  int next_chunk_ = 0, n_chunks_ = 0, pending_ = 0;
  uint64_t generation_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

int batcher_n_threads() { return Pool::instance().size() + 1; }

// Gather rows idx[0..n_idx) from n_fields contiguous 2-D arrays.
// srcs[f]: base pointer of field f; row_bytes[f]: bytes per row;
// dsts[f]: output base (n_idx rows, packed). Rows are split into chunks
// across the pool; every chunk copies all fields for its row range (dst
// writes stay streaming-contiguous per field).
void batcher_gather(int n_fields, const void** srcs, void** dsts,
                    const int64_t* row_bytes, const int32_t* idx,
                    int64_t n_idx) {
  if (n_idx <= 0 || n_fields <= 0) return;
  int n_threads = batcher_n_threads();
  // ~4 chunks per thread for load balance; >=64 rows per chunk so the
  // memcpy stream dominates scheduling overhead.
  int64_t chunk_rows = n_idx / (4 * n_threads);
  if (chunk_rows < 64) chunk_rows = 64;
  int n_chunks = static_cast<int>((n_idx + chunk_rows - 1) / chunk_rows);
  Pool::instance().run(n_chunks, [&](int c) {
    int64_t lo = c * chunk_rows;
    int64_t hi = lo + chunk_rows < n_idx ? lo + chunk_rows : n_idx;
    for (int f = 0; f < n_fields; ++f) {
      const char* src = static_cast<const char*>(srcs[f]);
      char* dst = static_cast<char*>(dsts[f]);
      const int64_t rb = row_bytes[f];
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * rb, src + static_cast<int64_t>(idx[i]) * rb,
                    rb);
    }
  });
}

}  // extern "C"
