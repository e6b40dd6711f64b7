// Native data plane: mmap + threaded prefetch batch loader.
//
// A copy of lycoris_tpu/native/loader.cpp (the same C ABI) for the PyTorch
// port, which never reads the JAX package's files. Python parses
// safetensors headers (JSON) and registers raw (file, offset, nbytes) tensor
// records; this library mmaps the shards and assembles batches into
// caller-provided buffers on a worker thread pool with a bounded prefetch
// queue, holding no GIL on the data plane. Batches come out in the order the
// workers finish them (each a run of the caller's permutation).
//
// Exposed as a plain C ABI for ctypes (lycoris_tpu_torch/data.py).
//
// Build (data.py does it at first use, into build/native/ at the repository
// root): g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libloader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  void* addr = nullptr;
  size_t size = 0;
};

struct Record {
  uint32_t file_id;
  uint64_t offset;
  uint64_t nbytes;
};

struct Batch {
  int64_t index;
  std::vector<uint8_t> data;
};

class Loader {
 public:
  Loader(uint64_t item_nbytes, uint32_t batch_size, uint32_t n_threads,
         uint32_t queue_depth)
      : item_nbytes_(item_nbytes),
        batch_size_(batch_size),
        queue_depth_(queue_depth ? queue_depth : 2),
        n_threads_(n_threads ? n_threads : 2) {}

  ~Loader() { stop(); unmap_all(); }

  int add_file(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return -1; }
    void* addr = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (addr == MAP_FAILED) return -1;
    ::madvise(addr, st.st_size, MADV_WILLNEED);
    files_.push_back({addr, static_cast<size_t>(st.st_size)});
    return static_cast<int>(files_.size()) - 1;
  }

  int add_record(uint32_t file_id, uint64_t offset, uint64_t nbytes) {
    if (file_id >= files_.size()) return -1;
    if (offset + nbytes > files_[file_id].size) return -1;
    if (nbytes != item_nbytes_) return -1;
    records_.push_back({file_id, offset, nbytes});
    return static_cast<int>(records_.size()) - 1;
  }

  // epoch order: caller supplies a permutation of record indices
  int start(const int64_t* order, uint64_t n) {
    stop();
    order_.assign(order, order + n);
    next_batch_idx_ = 0;
    produced_ = 0;
    stopping_ = false;
    n_batches_ = order_.size() / batch_size_;  // drop remainder
    for (uint32_t i = 0; i < n_threads_; ++i)
      workers_.emplace_back([this] { work(); });
    return 0;
  }

  // copy the next batch (batch_size * item_nbytes) into out; returns batch
  // index or -1 when the epoch is exhausted
  int64_t next(uint8_t* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_out_.wait(lk, [this] {
      return !queue_.empty() || (produced_ >= n_batches_ && queue_.empty());
    });
    if (queue_.empty()) return -1;
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    lk.unlock();
    cv_in_.notify_all();
    std::memcpy(out, b.data.data(), b.data.size());
    return b.index;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
    }
    cv_in_.notify_all();
    cv_out_.notify_all();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
    queue_.clear();
  }

  uint64_t n_batches() const { return n_batches_; }

 private:
  void work() {
    for (;;) {
      int64_t idx = next_batch_idx_.fetch_add(1);
      if (idx >= static_cast<int64_t>(n_batches_)) break;
      Batch b;
      b.index = idx;
      b.data.resize(static_cast<size_t>(batch_size_) * item_nbytes_);
      for (uint32_t i = 0; i < batch_size_; ++i) {
        const Record& r = records_[order_[idx * batch_size_ + i]];
        const uint8_t* src =
            static_cast<const uint8_t*>(files_[r.file_id].addr) + r.offset;
        std::memcpy(b.data.data() + static_cast<size_t>(i) * item_nbytes_, src,
                    item_nbytes_);
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_in_.wait(lk, [this] { return queue_.size() < queue_depth_ || stopping_; });
      if (stopping_) break;
      queue_.push_back(std::move(b));
      ++produced_;
      lk.unlock();
      cv_out_.notify_all();
    }
    // wake any consumer waiting on the last batches
    cv_out_.notify_all();
  }

  void unmap_all() {
    for (auto& f : files_)
      if (f.addr) ::munmap(f.addr, f.size);
    files_.clear();
  }

  uint64_t item_nbytes_;
  uint32_t batch_size_;
  uint32_t queue_depth_;
  uint32_t n_threads_;

  std::vector<MappedFile> files_;
  std::vector<Record> records_;
  std::vector<int64_t> order_;
  uint64_t n_batches_ = 0;

  std::vector<std::thread> workers_;
  std::deque<Batch> queue_;
  std::mutex mu_;
  std::condition_variable cv_in_, cv_out_;
  std::atomic<int64_t> next_batch_idx_{0};
  uint64_t produced_ = 0;
  bool stopping_ = false;
};

}  // namespace

extern "C" {

void* loader_create(uint64_t item_nbytes, uint32_t batch_size,
                    uint32_t n_threads, uint32_t queue_depth) {
  return new Loader(item_nbytes, batch_size, n_threads, queue_depth);
}

int loader_add_file(void* h, const char* path) {
  return static_cast<Loader*>(h)->add_file(path);
}

int loader_add_record(void* h, uint32_t file_id, uint64_t offset,
                      uint64_t nbytes) {
  return static_cast<Loader*>(h)->add_record(file_id, offset, nbytes);
}

int loader_start(void* h, const int64_t* order, uint64_t n) {
  return static_cast<Loader*>(h)->start(order, n);
}

int64_t loader_next(void* h, uint8_t* out) {
  return static_cast<Loader*>(h)->next(out);
}

uint64_t loader_n_batches(void* h) {
  return static_cast<Loader*>(h)->n_batches();
}

void loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
