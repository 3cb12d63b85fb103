// Native record-IO codec + threaded prefetch loader: the port's own copy
// of paddle_tpu/runtime/native/recordio.cc, built by
// paddle_tpu_torch/runtime/native/__init__.py into build/native/.
//
// The reference's native data plumbing: the Go recordio library feeding
// go/master task dispatch (go/master/service.go partitions datasets into
// recordio chunks) and the C++ data providers with background-thread
// double buffering (paddle/gserver/dataproviders/DataProvider.h:292,
// PyDataProvider2.cpp:195 DoubleBuffer).
//
// Format (must match paddle_tpu_torch/runtime/recordio.py, and the JAX
// package's files byte for byte):
//   chunk = [u32 magic][u32 nrecords][u64 payload_len][u32 crc32]
//           [payload: nrecords x (u32 len + bytes)]
//
// C ABI only, consumed from Python via ctypes.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x0A0D5EC5;
constexpr size_t kHeaderSize = 4 + 4 + 8 + 4;

#pragma pack(push, 1)
struct ChunkHeader {
  uint32_t magic;
  uint32_t nrecords;
  uint64_t payload_len;
  uint32_t crc;
};
#pragma pack(pop)

static_assert(sizeof(ChunkHeader) == kHeaderSize, "header packing");

struct Chunk {
  std::vector<uint8_t> payload;
  uint32_t nrecords = 0;
};

// Reads one chunk at `offset`; returns 0 on success, negative error code.
int read_chunk_at(FILE* f, long offset, Chunk* out) {
  if (fseek(f, offset, SEEK_SET) != 0) return -2;
  ChunkHeader h;
  if (fread(&h, 1, sizeof(h), f) != sizeof(h)) return -3;
  if (h.magic != kMagic) return -4;
  out->payload.resize(h.payload_len);
  if (h.payload_len &&
      fread(out->payload.data(), 1, h.payload_len, f) != h.payload_len)
    return -5;
  uint32_t crc =
      crc32(0, out->payload.data(), static_cast<uInt>(h.payload_len));
  if (crc != h.crc) return -6;
  out->nrecords = h.nrecords;
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Index: scan chunk headers. Returns #chunks (or negative errno-style code);
// fills malloc'd arrays the caller frees with rio_free.
// ---------------------------------------------------------------------------
long rio_index(const char* path, long long** offsets, unsigned int** counts) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<long long> offs;
  std::vector<unsigned int> cnts;
  for (;;) {
    long pos = ftell(f);
    ChunkHeader h;
    size_t got = fread(&h, 1, sizeof(h), f);
    if (got == 0) break;               // clean EOF
    if (got != sizeof(h) || h.magic != kMagic) {
      fclose(f);
      return -4;
    }
    offs.push_back(pos);
    cnts.push_back(h.nrecords);
    if (fseek(f, static_cast<long>(h.payload_len), SEEK_CUR) != 0) {
      fclose(f);
      return -2;
    }
  }
  fclose(f);
  *offsets = static_cast<long long*>(malloc(offs.size() * sizeof(long long)));
  *counts =
      static_cast<unsigned int*>(malloc(cnts.size() * sizeof(unsigned int)));
  memcpy(*offsets, offs.data(), offs.size() * sizeof(long long));
  memcpy(*counts, cnts.data(), cnts.size() * sizeof(unsigned int));
  return static_cast<long>(offs.size());
}

// ---------------------------------------------------------------------------
// Read one chunk's payload (CRC-checked). Returns payload length or negative
// error; payload malloc'd, record count in *nrecords.
// ---------------------------------------------------------------------------
long long rio_read_chunk(const char* path, long long offset, uint8_t** payload,
                         unsigned int* nrecords) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Chunk c;
  int rc = read_chunk_at(f, static_cast<long>(offset), &c);
  fclose(f);
  if (rc != 0) return rc;
  *payload = static_cast<uint8_t*>(malloc(c.payload.size()));
  memcpy(*payload, c.payload.data(), c.payload.size());
  *nrecords = c.nrecords;
  return static_cast<long long>(c.payload.size());
}

// ---------------------------------------------------------------------------
// Write chunks: records passed as one buffer + per-record lengths.
// Appends to `path` (caller truncates first if overwriting).
// ---------------------------------------------------------------------------
long long rio_write_chunk(const char* path, const uint8_t* data,
                          const unsigned int* lens, unsigned int nrecords) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  uint64_t payload_len = 0;
  for (unsigned int i = 0; i < nrecords; i++)
    payload_len += 4ull + lens[i];
  std::vector<uint8_t> payload(payload_len);
  size_t pos = 0;
  const uint8_t* src = data;
  for (unsigned int i = 0; i < nrecords; i++) {
    uint32_t len = lens[i];
    memcpy(payload.data() + pos, &len, 4);
    pos += 4;
    memcpy(payload.data() + pos, src, len);
    pos += len;
    src += len;
  }
  ChunkHeader h{kMagic, nrecords, payload_len,
                crc32(0, payload.data(), static_cast<uInt>(payload_len))};
  long long total = -7;
  if (fwrite(&h, 1, sizeof(h), f) == sizeof(h) &&
      fwrite(payload.data(), 1, payload.size(), f) == payload.size())
    total = static_cast<long long>(sizeof(h) + payload.size());
  fclose(f);
  return total;
}

void rio_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Prefetch loader: N reader threads pull chunk indices off a work list,
// decode records, and push them into a bounded queue — the DataProvider
// double-buffer equivalent, decoupling disk+decode from the train loop.
// ---------------------------------------------------------------------------
struct Loader {
  std::string path;
  std::vector<long long> offsets;       // chunk order (pre-shuffled by caller)
  size_t next_chunk = 0;
  size_t capacity;
  std::deque<std::vector<uint8_t>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> threads;
  std::atomic<int> active_readers{0};
  std::atomic<bool> stop{false};
  std::atomic<int> error{0};
  // error deferred by loader_next_batch so a partially-assembled batch
  // is returned to the caller before the error surfaces
  std::atomic<long long> pending_error{0};

  void reader_loop() {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) {
      error.store(-1);
      active_readers.fetch_sub(1);
      cv_pop.notify_all();
      return;
    }
    for (;;) {
      size_t idx;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stop.load() || next_chunk >= offsets.size()) break;
        idx = next_chunk++;
      }
      Chunk c;
      int rc = read_chunk_at(f, static_cast<long>(offsets[idx]), &c);
      if (rc != 0) {
        error.store(rc);
        break;
      }
      // split payload into records, enqueue each
      size_t pos = 0;
      for (uint32_t r = 0; r < c.nrecords && !stop.load(); r++) {
        uint32_t len;
        memcpy(&len, c.payload.data() + pos, 4);
        pos += 4;
        std::vector<uint8_t> rec(c.payload.begin() + pos,
                                 c.payload.begin() + pos + len);
        pos += len;
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < capacity || stop.load(); });
        if (stop.load()) break;
        queue.push_back(std::move(rec));
        cv_pop.notify_one();
      }
    }
    fclose(f);
    active_readers.fetch_sub(1);
    cv_pop.notify_all();
  }
};

void* loader_create(const char* path, const long long* offsets, long nchunks,
                    int nthreads, long capacity) {
  Loader* L = new Loader();
  L->path = path;
  L->offsets.assign(offsets, offsets + nchunks);
  L->capacity = static_cast<size_t>(capacity);
  L->active_readers.store(nthreads);
  for (int i = 0; i < nthreads; i++)
    L->threads.emplace_back([L] { L->reader_loop(); });
  return L;
}

// Pops one record; blocks. Returns length, 0 at end-of-data, negative error.
long long loader_next(void* handle, uint8_t** rec) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] {
    return !L->queue.empty() || L->active_readers.load() == 0 ||
           L->error.load() != 0;
  });
  if (L->error.load() != 0 && L->queue.empty()) return L->error.load();
  if (L->queue.empty()) return 0;  // drained
  std::vector<uint8_t> r = std::move(L->queue.front());
  L->queue.pop_front();
  L->cv_push.notify_one();
  lk.unlock();
  *rec = static_cast<uint8_t*>(malloc(r.size()));
  memcpy(*rec, r.data(), r.size());
  return static_cast<long long>(r.size());
}

// Pops up to `batch` fixed-size records straight into the caller's buffer
// (a [batch, rec_bytes] matrix) — the native batch-assembly path: no
// per-record malloc, no per-record language crossing. Returns the number
// of records copied (0 = drained), -100 on a record whose size !=
// rec_bytes (distinct from the chunk-reader's -1..-4 I/O codes), or the
// loader's error code. An error hit after n>0 records were already
// copied is DEFERRED: the partial count is returned first and the error
// surfaces on the next call, so no copied record is ever discarded.
// Short counts therefore mean end-of-data OR an error about to surface.
// The mismatched record itself cannot fit the matrix and is dropped.
long long loader_next_batch(void* handle, uint8_t* out, long batch,
                            long long rec_bytes) {
  Loader* L = static_cast<Loader*>(handle);
  long long pending = L->pending_error.exchange(0);
  if (pending != 0) return pending;
  long n = 0;
  while (n < batch) {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [&] {
      return !L->queue.empty() || L->active_readers.load() == 0 ||
             L->error.load() != 0;
    });
    if (L->queue.empty()) {
      if (L->error.load() != 0) {
        if (n > 0) {
          L->pending_error.store(L->error.load());
          break;
        }
        return L->error.load();
      }
      break;  // drained: return the short tail
    }
    std::vector<uint8_t> r = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
    lk.unlock();
    if (static_cast<long long>(r.size()) != rec_bytes) {
      if (n > 0) {
        L->pending_error.store(-100);
        break;
      }
      return -100;
    }
    memcpy(out + static_cast<size_t>(n) * rec_bytes, r.data(), r.size());
    n++;
  }
  return n;
}

void loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->threads) t.join();
  delete L;
}

}  // extern "C"
