// Native timeline writer: chrome-tracing JSON with a background flush thread.
//
// Host-side counterpart of the reference's timeline machinery
// (common/timeline.{h,cc}): there, a TimelineWriter drains a lock-free
// spsc_queue (capacity 1M) on a dedicated thread so the hot path never
// blocks on file IO.  Same design here, exposed as a C API for ctypes:
// record() pushes an event into a fixed-capacity ring buffer (drops on
// overflow, like the reference's WriteEvent when the queue is full) and a
// writer thread serializes events to <path> as chrome-tracing JSON.
//
// Built by bluefog_tpu_torch/_native/__init__.py (g++ -O2 -shared -fPIC).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Event {
  char name[96];
  char cat[64];
  char ph;  // 'X' complete, 'B' begin, 'E' end, 'i' instant
  int64_t ts_us;
  int64_t dur_us;
  int32_t pid;
  int32_t tid;
};

constexpr size_t kCapacity = 1 << 20;  // 1M events, reference timeline.h:65

class TimelineWriter {
 public:
  bool Start(const char* path) {
    std::lock_guard<std::mutex> lk(state_mu_);
    if (running_.load()) return false;
    file_ = std::fopen(path, "w");
    if (!file_) return false;
    std::fputs("{\"displayTimeUnit\": \"ms\", \"traceEvents\": [\n", file_);
    first_event_ = true;
    head_.store(0);
    tail_.store(0);
    dropped_.store(0);
    running_.store(true);
    thread_ = std::thread(&TimelineWriter::Loop, this);
    return true;
  }

  // Push one event; returns false when the ring is full (event dropped).
  bool Record(const char* name, const char* cat, char ph, int64_t ts_us,
              int64_t dur_us, int32_t pid, int32_t tid) {
    if (!running_.load(std::memory_order_acquire)) return false;
    size_t head = head_.load(std::memory_order_relaxed);
    size_t next = (head + 1) % kCapacity;
    if (next == tail_.load(std::memory_order_acquire)) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    Event& e = ring_[head];
    std::snprintf(e.name, sizeof(e.name), "%s", name);
    std::snprintf(e.cat, sizeof(e.cat), "%s", cat);
    e.ph = ph;
    e.ts_us = ts_us;
    e.dur_us = dur_us;
    e.pid = pid;
    e.tid = tid;
    head_.store(next, std::memory_order_release);
    cv_.notify_one();
    return true;
  }

  int64_t Stop() {
    {
      std::lock_guard<std::mutex> lk(state_mu_);
      if (!running_.load()) return -1;
      running_.store(false);
    }
    cv_.notify_one();
    if (thread_.joinable()) thread_.join();
    Drain();
    std::fputs("\n]}\n", file_);
    std::fclose(file_);
    file_ = nullptr;
    return static_cast<int64_t>(dropped_.load());
  }

  int64_t Dropped() const { return static_cast<int64_t>(dropped_.load()); }

 private:
  void Loop() {
    while (running_.load(std::memory_order_acquire)) {
      {
        std::unique_lock<std::mutex> lk(cv_mu_);
        cv_.wait_for(lk, std::chrono::milliseconds(100));
      }
      Drain();
    }
  }

  void Drain() {
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t head = head_.load(std::memory_order_acquire);
    while (tail != head) {
      WriteEvent(ring_[tail]);
      tail = (tail + 1) % kCapacity;
    }
    tail_.store(tail, std::memory_order_release);
  }

  void WriteEvent(const Event& e) {
    if (!first_event_) std::fputs(",\n", file_);
    first_event_ = false;
    // chrome-tracing complete/instant event record
    if (e.ph == 'X') {
      std::fprintf(file_,
                   "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"X\", "
                   "\"ts\": %lld, \"dur\": %lld, \"pid\": %d, \"tid\": %d}",
                   e.name, e.cat, static_cast<long long>(e.ts_us),
                   static_cast<long long>(e.dur_us), e.pid, e.tid);
    } else {
      std::fprintf(file_,
                   "{\"name\": \"%s\", \"cat\": \"%s\", \"ph\": \"%c\", "
                   "\"ts\": %lld, \"pid\": %d, \"tid\": %d}",
                   e.name, e.cat, e.ph, static_cast<long long>(e.ts_us),
                   e.pid, e.tid);
    }
  }

  std::vector<Event> ring_{kCapacity};
  std::atomic<size_t> head_{0};
  std::atomic<size_t> tail_{0};
  std::atomic<bool> running_{false};
  std::atomic<uint64_t> dropped_{0};
  std::FILE* file_ = nullptr;
  bool first_event_ = true;
  std::thread thread_;
  std::mutex state_mu_;
  std::mutex cv_mu_;
  std::condition_variable cv_;
};

TimelineWriter g_writer;

}  // namespace

extern "C" {

int bft_timeline_start(const char* path) { return g_writer.Start(path) ? 1 : 0; }

int bft_timeline_record(const char* name, const char* cat, char ph,
                        int64_t ts_us, int64_t dur_us, int32_t pid,
                        int32_t tid) {
  return g_writer.Record(name, cat, ph, ts_us, dur_us, pid, tid) ? 1 : 0;
}

int64_t bft_timeline_stop() { return g_writer.Stop(); }

int64_t bft_timeline_dropped() { return g_writer.Dropped(); }

}  // extern "C"
