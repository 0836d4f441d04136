// Host-side token data loader: mmap'd shard files + a background prefetch
// ring, exposed through a C ABI consumed via ctypes (train/data.py
// TokenFileDataset).
//
// The port's copy of tf_operator_tpu/native/dataloader.cc: the same source,
// so that both packages cut the same windows from the same file (kStride and
// the window arithmetic must stay in step with that file and with
// TokenFileDataset._STRIDE). Batch assembly from disk overlaps the device
// step and never blocks the Python thread that launches it.
//
// File format ("tokens v1"): raw little-endian token ids, dtype int32 or
// uint16, no header — the Python side passes dtype and the file length
// defines the token count. Readers slice fixed windows of seq+1 tokens:
// window w starts at ((w * stride + offset) % usable) where usable =
// n_tokens - (seq+1); stride is a large odd constant so successive windows
// decorrelate without an index shuffle allocation.
//
// Distributed: each process opens the same file with (process_id,
// num_processes); window ids advance by num_processes so shards are
// disjoint and the union covers the stream.
//
// Threading: one producer thread fills a ring of `depth` batch buffers;
// next() blocks only when the producer is behind. No locks on the hot
// path beyond the ring's mutex/condvar handoff.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Ring {
  std::vector<std::vector<int32_t>> slots;
  std::vector<bool> full;
  size_t head = 0;  // next slot the consumer reads
  size_t tail = 0;  // next slot the producer fills
  std::mutex mu;
  std::condition_variable can_produce;
  std::condition_variable can_consume;
};

struct Loader {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t file_bytes = 0;
  int64_t n_tokens = 0;
  int dtype_bytes = 4;  // 4 = int32, 2 = uint16
  int64_t batch = 0;
  int64_t seq = 0;        // window = seq + 1 tokens
  int64_t process_id = 0;
  int64_t num_processes = 1;
  std::atomic<int64_t> window{0};
  Ring ring;
  std::thread producer;
  std::atomic<bool> stop{false};
};

constexpr int64_t kStride = 1000003;  // large odd prime: decorrelated windows

int64_t usable(const Loader* l) {
  int64_t u = l->n_tokens - (l->seq + 1);
  // Degenerate stride cycle: if u divides kStride's multiples exactly
  // ((w*kStride) mod u visits only u/kStride offsets), nudge u so the
  // prime stride is coprime again. Mirrored in train/data.py.
  if (u % kStride == 0) --u;
  return u;
}

void fill_batch(Loader* l, int32_t* out) {
  const int64_t win = l->seq + 1;
  for (int64_t b = 0; b < l->batch; ++b) {
    const int64_t w = l->window.fetch_add(1) * l->num_processes + l->process_id;
    const int64_t start = ((w * kStride) % usable(l) + usable(l)) % usable(l);
    if (l->dtype_bytes == 4) {
      std::memcpy(out + b * win,
                  reinterpret_cast<const int32_t*>(l->data) + start,
                  win * sizeof(int32_t));
    } else {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(l->data) + start;
      int32_t* dst = out + b * win;
      for (int64_t i = 0; i < win; ++i) dst[i] = static_cast<int32_t>(src[i]);
    }
  }
}

void producer_loop(Loader* l) {
  for (;;) {
    std::unique_lock<std::mutex> lk(l->ring.mu);
    l->ring.can_produce.wait(
        lk, [l] { return l->stop.load() || !l->ring.full[l->ring.tail]; });
    if (l->stop.load()) return;
    const size_t slot = l->ring.tail;
    lk.unlock();
    fill_batch(l, l->ring.slots[slot].data());
    lk.lock();
    l->ring.full[slot] = true;
    l->ring.tail = (slot + 1) % l->ring.slots.size();
    l->ring.can_consume.notify_one();
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure. `skip_windows` pre-advances
// this process's window counter (checkpoint resume: windows already
// consumed must not replay).
void* tl_open(const char* path, int64_t batch, int64_t seq, int dtype_bytes,
              int64_t process_id, int64_t num_processes, int64_t depth,
              int64_t skip_windows) {
  if (dtype_bytes != 2 && dtype_bytes != 4) return nullptr;
  if (batch <= 0 || seq <= 0 || depth <= 0 || num_processes <= 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    ::close(fd);
    return nullptr;
  }
  void* data = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (data == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(data, st.st_size, MADV_WILLNEED);

  auto* l = new Loader();
  l->fd = fd;
  l->data = static_cast<const uint8_t*>(data);
  l->file_bytes = st.st_size;
  l->dtype_bytes = dtype_bytes;
  l->n_tokens = st.st_size / dtype_bytes;
  l->batch = batch;
  l->seq = seq;
  l->process_id = process_id;
  l->num_processes = num_processes;
  l->window.store(skip_windows);
  if (usable(l) <= 0) {
    ::munmap(data, st.st_size);
    ::close(fd);
    delete l;
    return nullptr;
  }
  const size_t batch_elems = static_cast<size_t>(batch) * (seq + 1);
  l->ring.slots.assign(depth, std::vector<int32_t>(batch_elems));
  l->ring.full.assign(depth, false);
  l->producer = std::thread(producer_loop, l);
  return l;
}

// Copies the next [batch, seq+1] int32 batch into `out`; returns 0 on
// success. Single-consumer contract: tl_close must NOT be called
// concurrently with tl_next (close frees the loader) — the nonzero return
// exists only as an internal shutdown guard for the producer handoff, not
// as a sanctioned call-after-close protocol.
int tl_next(void* handle, int32_t* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->ring.mu);
  l->ring.can_consume.wait(
      lk, [l] { return l->stop.load() || l->ring.full[l->ring.head]; });
  if (l->stop.load()) return 1;
  const size_t slot = l->ring.head;
  lk.unlock();
  std::memcpy(out, l->ring.slots[slot].data(),
              l->ring.slots[slot].size() * sizeof(int32_t));
  lk.lock();
  l->ring.full[slot] = false;
  l->ring.head = (slot + 1) % l->ring.slots.size();
  l->ring.can_produce.notify_one();
  return 0;
}

int64_t tl_token_count(void* handle) {
  return static_cast<Loader*>(handle)->n_tokens;
}

void tl_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->ring.mu);
    l->stop.store(true);
  }
  l->ring.can_produce.notify_all();
  l->ring.can_consume.notify_all();
  if (l->producer.joinable()) l->producer.join();
  ::munmap(const_cast<uint8_t*>(l->data), l->file_bytes);
  ::close(l->fd);
  delete l;
}

}  // extern "C"
