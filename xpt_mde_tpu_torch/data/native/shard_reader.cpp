// Native shard reader: mmap-backed batched record gather + image decode.
//
// A copy of xpt_mde_tpu/data/native/shard_reader.cpp for the PyTorch port:
// the runtime counterpart of xpt_mde_tpu_torch/data/shard_io.py. Python
// owns the schema (shard_config.json); this library owns the hot loop:
//
//   - shards are mmap'd once per epoch-lifetime (no per-batch syscalls);
//   - a batch is N random records gathered by memcpy across threads;
//   - the uint8 snippet image -> float32 [-1, 1] conversion (the most
//     expensive per-batch host op) runs here, multithreaded, writing
//     straight into the caller's pinned buffer.
//
// Built as a plain C ABI shared object (no pybind11 dependency); loaded
// from Python with ctypes (xpt_mde_tpu_torch/data/native_loader.py), which
// builds it with g++ at first use into build/native/<source hash>/.

#include <algorithm>
#include <cstdint>
#include <functional>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  void *orig = nullptr;   // mmap base (for munmap)
  const uint8_t *data = nullptr;  // records start (after magic)
  size_t bytes = 0;
  int64_t first_record = 0;
  int64_t num_records = 0;
};

struct Reader {
  std::vector<Shard> shards;
  int64_t record_nbytes = 0;
  int64_t total_records = 0;
  int num_threads = 4;

  const uint8_t *record_ptr(int64_t idx) const {
    for (const Shard &s : shards) {
      if (idx < s.first_record + s.num_records) {
        return s.data + (idx - s.first_record) * record_nbytes;
      }
    }
    return nullptr;
  }
};

void parallel_for(int num_threads, int64_t n,
                  const std::function<void(int64_t, int64_t)> &fn) {
  if (n <= 0) return;
  int threads = std::min<int64_t>(num_threads, n);
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto &th : pool) th.join();
}

} // namespace

extern "C" {

// Open a reader over shard files. `magic_bytes` is the per-file header
// size to skip. Returns an opaque handle or nullptr.
void *sr_open(const char **paths, int num_paths, int64_t record_nbytes,
              int64_t magic_bytes, int num_threads) {
  auto *r = new Reader();
  r->record_nbytes = record_nbytes;
  r->num_threads = num_threads > 0 ? num_threads : 4;
  int64_t offset = 0;
  for (int i = 0; i < num_paths; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) { delete r; return nullptr; }
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); delete r; return nullptr; }
    void *map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (map == MAP_FAILED) { delete r; return nullptr; }
    madvise(map, st.st_size, MADV_WILLNEED);
    Shard s;
    s.orig = map;
    s.data = static_cast<const uint8_t *>(map) + magic_bytes;
    s.bytes = st.st_size;
    s.first_record = offset;
    s.num_records = (st.st_size - magic_bytes) / record_nbytes;
    offset += s.num_records;
    r->shards.push_back(s);
  }
  r->total_records = offset;
  return r;
}

int64_t sr_num_records(void *handle) {
  return static_cast<Reader *>(handle)->total_records;
}

// Gather `n` records by index into `out` (n * record_nbytes bytes).
int sr_read_batch(void *handle, const int64_t *indices, int64_t n,
                  uint8_t *out) {
  auto *r = static_cast<Reader *>(handle);
  bool ok = true;
  parallel_for(r->num_threads, n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t *src = r->record_ptr(indices[i]);
      if (!src) { ok = false; continue; }
      memcpy(out + i * r->record_nbytes, src, r->record_nbytes);
    }
  });
  return ok ? 0 : -1;
}

// Decode a uint8 image block to float32 in [-1, 1], multithreaded.
void sr_decode_images(const uint8_t *src, float *dst, int64_t count,
                      int num_threads) {
  const float scale = 2.0f / 255.0f;
  parallel_for(num_threads > 0 ? num_threads : 4, count,
               [&](int64_t lo, int64_t hi) {
                 for (int64_t i = lo; i < hi; ++i) {
                   dst[i] = static_cast<float>(src[i]) * scale - 1.0f;
                 }
               });
}

// Gather records AND decode an image field in one pass: for each of the
// `n` records, copy `img_nbytes` at `img_offset` decoded to float, and
// the remaining bytes raw into `rest_out`.
int sr_read_batch_decoded(void *handle, const int64_t *indices, int64_t n,
                          int64_t img_offset, int64_t img_nbytes,
                          float *img_out, uint8_t *rest_out) {
  auto *r = static_cast<Reader *>(handle);
  const float scale = 2.0f / 255.0f;
  const int64_t rest_nbytes = r->record_nbytes - img_nbytes;
  bool ok = true;
  parallel_for(r->num_threads, n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t *src = r->record_ptr(indices[i]);
      if (!src) { ok = false; continue; }
      const uint8_t *img = src + img_offset;
      float *out = img_out + i * img_nbytes;
      for (int64_t j = 0; j < img_nbytes; ++j) {
        out[j] = static_cast<float>(img[j]) * scale - 1.0f;
      }
      // bytes before and after the image field
      uint8_t *rest = rest_out + i * rest_nbytes;
      memcpy(rest, src, img_offset);
      memcpy(rest + img_offset, src + img_offset + img_nbytes,
             r->record_nbytes - img_offset - img_nbytes);
    }
  });
  return ok ? 0 : -1;
}

void sr_close(void *handle) {
  auto *r = static_cast<Reader *>(handle);
  for (Shard &s : r->shards) {
    munmap(s.orig, s.bytes);
  }
  delete r;
}

} // extern "C"
