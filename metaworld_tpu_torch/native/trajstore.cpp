// trajstore: lock-free-ish ring buffer + background disk writer for rollout
// batches.
//
// The runtime IO component of metaworld_tpu_torch: the device step loop
// emits rollout blocks (obs/action/reward arrays) at millions of steps per
// second; this store absorbs them into a preallocated ring without blocking
// the step loop, while a native thread drains records to disk. The port's
// copy of metaworld_tpu/native/trajstore.cpp: the same C API and the same
// record framing, so either package reads the other's files; ts_create
// returns null when the file cannot be opened.
//
// C API (ctypes-friendly):
//   ts_create(capacity_bytes, path) -> handle, or null if path won't open
//   ts_push(handle, data, nbytes)   -> 0 ok / -1 would-block (ring full)
//   ts_flush(handle)                -> blocks until the ring is drained
//   ts_stats(handle, out[3])        -> {pushed_records, dropped, bytes_written}
//   ts_close(handle)
//
// Record framing on disk: [u64 magic][u64 nbytes][payload...] repeated.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x4d57545053544f52ull;  // "MWTPSTOR"

struct Record {
  uint64_t offset;
  uint64_t nbytes;
};

class TrajStore {
 public:
  TrajStore(size_t capacity, std::FILE* file)
      : buf_(capacity), capacity_(capacity), file_(file) {
    writer_ = std::thread([this] { this->WriterLoop(); });
  }

  ~TrajStore() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_ = true;
      cv_.notify_all();
    }
    writer_.join();
    if (file_) std::fclose(file_);
  }

  int Push(const uint8_t* data, size_t nbytes) {
    std::unique_lock<std::mutex> lk(mu_);
    if (used_ + nbytes > capacity_ || nbytes > capacity_) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return -1;
    }
    Record rec{head_, nbytes};
    size_t first = std::min(nbytes, capacity_ - head_);
    std::memcpy(buf_.data() + head_, data, first);
    if (first < nbytes) std::memcpy(buf_.data(), data + first, nbytes - first);
    head_ = (head_ + nbytes) % capacity_;
    used_ += nbytes;
    queue_.push_back(rec);
    pushed_.fetch_add(1, std::memory_order_relaxed);
    cv_.notify_one();
    return 0;
  }

  void Flush() {
    std::unique_lock<std::mutex> lk(mu_);
    // A record leaves queue_ BEFORE its fwrite happens, so queue_.empty()
    // alone would let Flush return (and fflush race the fwrite) while the
    // last record is still being written; in_flight_ covers that window.
    flush_cv_.wait(lk, [this] { return queue_.empty() && in_flight_ == 0; });
    if (file_) std::fflush(file_);
  }

  void Stats(uint64_t out[3]) const {
    out[0] = pushed_.load(std::memory_order_relaxed);
    out[1] = dropped_.load(std::memory_order_relaxed);
    out[2] = bytes_written_.load(std::memory_order_relaxed);
  }

 private:
  void WriterLoop() {
    std::vector<uint8_t> scratch;
    for (;;) {
      Record rec;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return done_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (done_) return;
          continue;
        }
        rec = queue_.front();
        queue_.pop_front();
        ++in_flight_;  // under mu_: Flush must wait for this record's fwrite
      }
      scratch.resize(rec.nbytes);
      size_t first = std::min<size_t>(rec.nbytes, capacity_ - rec.offset);
      std::memcpy(scratch.data(), buf_.data() + rec.offset, first);
      if (first < rec.nbytes)
        std::memcpy(scratch.data() + first, buf_.data(), rec.nbytes - first);

      uint64_t hdr[2] = {kMagic, rec.nbytes};
      std::fwrite(hdr, sizeof(hdr), 1, file_);
      std::fwrite(scratch.data(), 1, rec.nbytes, file_);
      bytes_written_.fetch_add(rec.nbytes + sizeof(hdr),
                               std::memory_order_relaxed);
      {
        std::unique_lock<std::mutex> lk(mu_);
        used_ -= rec.nbytes;
        --in_flight_;
        if (queue_.empty() && in_flight_ == 0) flush_cv_.notify_all();
      }
    }
  }

  std::vector<uint8_t> buf_;
  size_t capacity_;
  size_t head_ = 0;
  size_t used_ = 0;
  size_t in_flight_ = 0;  // records popped from queue_ but not yet on disk
  std::deque<Record> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable flush_cv_;
  bool done_ = false;
  std::FILE* file_ = nullptr;
  std::thread writer_;
  std::atomic<uint64_t> pushed_{0}, dropped_{0}, bytes_written_{0};
};

}  // namespace

extern "C" {

void* ts_create(uint64_t capacity, const char* path) {
  std::FILE* file = std::fopen(path, "wb");
  if (!file) return nullptr;
  return new TrajStore(static_cast<size_t>(capacity), file);
}

int ts_push(void* h, const uint8_t* data, uint64_t nbytes) {
  return static_cast<TrajStore*>(h)->Push(data, static_cast<size_t>(nbytes));
}

void ts_flush(void* h) { static_cast<TrajStore*>(h)->Flush(); }

void ts_stats(void* h, uint64_t* out) { static_cast<TrajStore*>(h)->Stats(out); }

void ts_close(void* h) { delete static_cast<TrajStore*>(h); }

}  // extern "C"
