// The PyTorch port's copy of native/shmring.cpp (same ring layout, same C
// interface): control/shmring.py builds it with g++ into build/shmring/ at
// first use and loads it with ctypes, so rings made by either package's
// library open in the other's.
//
// Shared-memory ring buffer: the native high-throughput feed transport.
//
// The reference's feed plane moved one pickled row per
// multiprocessing.Manager round-trip (reference TFSparkNode.py:500-502 →
// TFNode.py:276-300, two IPC hops per row — its known bottleneck,
// SURVEY.md §3.2). This ring moves serialized record batches through POSIX
// shared memory with zero copies beyond the serialize/deserialize, for the
// single-producer/single-consumer topology the engine guarantees (one
// feeder task at a time per executor).
//
// Layout: Header | data[capacity]. Byte ring with 4-byte-length-prefixed
// records; a record never wraps — if it doesn't fit contiguously before
// the end, a SKIP marker pads to the end and the record starts at 0.
// head/tail are monotonically increasing byte offsets (mod capacity on
// access); C++11 atomics give SPSC correctness with acquire/release.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t SKIP = 0xFFFFFFFFu;
constexpr uint64_t MAGIC = 0x544f535252494e47ull;  // "TOSRRING"

struct Header {
  uint64_t magic;
  uint64_t capacity;
  std::atomic<uint64_t> head;   // producer byte offset (monotonic)
  std::atomic<uint64_t> tail;   // consumer byte offset (monotonic)
  std::atomic<uint32_t> closed;
};

struct Ring {
  Header* hdr;
  uint8_t* data;
  size_t map_len;
};

void sleep_us(unsigned us) {
  struct timespec ts {0, static_cast<long>(us) * 1000L};
  nanosleep(&ts, nullptr);
}

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

}  // namespace

extern "C" {

void* tos_ring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale ring from a dead run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t total = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = static_cast<Header*>(mem);
  hdr->capacity = capacity;
  hdr->head.store(0);
  hdr->tail.store(0);
  hdr->closed.store(0);
  hdr->magic = MAGIC;
  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(Header), total};
  return r;
}

void* tos_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(sizeof(Header))) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<Header*>(mem);
  if (hdr->magic != MAGIC) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(Header),
                     static_cast<size_t>(st.st_size)};
  return r;
}

// 0 = ok, 1 = timeout, 2 = closed, 3 = record too large
int tos_ring_write(void* handle, const uint8_t* rec, uint32_t len,
                   int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  Header* h = r->hdr;
  const uint64_t cap = h->capacity;
  const uint64_t need = 4ull + len;
  if (need + 4 > cap) return 3;  // must leave room for a SKIP marker
  const uint64_t deadline = timeout_ms < 0 ? ~0ull : now_ms() + timeout_ms;

  for (;;) {
    if (h->closed.load(std::memory_order_acquire)) return 2;
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    uint64_t pos = head % cap;
    uint64_t to_end = cap - pos;
    uint64_t required = need;
    bool pad = false;
    if (to_end < need) {        // record would wrap: pad to end, restart at 0
      required = to_end + need;
      pad = true;
    }
    if (cap - (head - tail) >= required) {
      if (pad) {
        if (to_end >= 4)
          memcpy(r->data + pos, &SKIP, 4);
        head += to_end;
        pos = 0;
      }
      memcpy(r->data + pos, &len, 4);
      memcpy(r->data + pos + 4, rec, len);
      h->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (now_ms() > deadline) return 1;
    sleep_us(100);
  }
}

// >=0 record length, -1 timeout, -2 closed+drained, -3 buffer too small
int64_t tos_ring_read(void* handle, uint8_t* buf, uint32_t buf_len,
                      int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  Header* h = r->hdr;
  const uint64_t cap = h->capacity;
  const uint64_t deadline = timeout_ms < 0 ? ~0ull : now_ms() + timeout_ms;

  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head != tail) {
      uint64_t pos = tail % cap;
      uint64_t to_end = cap - pos;
      uint32_t len;
      if (to_end < 4) {         // implicit pad (SKIP marker didn't fit)
        h->tail.store(tail + to_end, std::memory_order_release);
        continue;
      }
      memcpy(&len, r->data + pos, 4);
      if (len == SKIP) {        // explicit pad to end of buffer
        h->tail.store(tail + to_end, std::memory_order_release);
        continue;
      }
      if (len > buf_len) return -3;
      memcpy(buf, r->data + pos + 4, len);
      h->tail.store(tail + 4ull + len, std::memory_order_release);
      return static_cast<int64_t>(len);
    }
    if (h->closed.load(std::memory_order_acquire)) return -2;
    if (now_ms() > deadline) return -1;
    sleep_us(100);
  }
}

void tos_ring_close_write(void* handle) {
  static_cast<Ring*>(handle)->hdr->closed.store(
      1, std::memory_order_release);
}

uint64_t tos_ring_pending(void* handle) {
  auto* h = static_cast<Ring*>(handle)->hdr;
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

void tos_ring_free(void* handle, const char* name, int unlink_shm) {
  auto* r = static_cast<Ring*>(handle);
  munmap(r->hdr, r->map_len);
  if (unlink_shm) shm_unlink(name);
  delete r;
}

}  // extern "C"
