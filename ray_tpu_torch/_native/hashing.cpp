// Native kernels for the data plane: row hashing + partition assignment
// (the port's copy of ray_tpu/_native/hashing.cpp; the functions are the
// same, so hashes and partitions equal ray_tpu's).
//
// The host's CPU-bound inner loops of joins and group-bys: hashing
// variable-length string/bytes rows (a Python loop otherwise) and
// bucketing rows for hash-shuffle joins. Built with g++ -O3 at first use
// (ray_tpu_torch/_native/__init__.py), called through ctypes on numpy
// buffers: an offsets array into one contiguous byte buffer for string
// and bytes columns, the 64-bit patterns of numeric keys.

#include <cstdint>
#include <cstddef>

extern "C" {

// splitmix64: well-mixed 64-bit integer hash
static inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// FNV-1a over one byte run
static inline uint64_t fnv1a(const uint8_t* p, int64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < len; ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// hash fixed-width 64-bit keys (int64/float64 bit patterns)
void hash_u64(const uint64_t* keys, int64_t n, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = mix64(keys[i]);
}

// hash variable-length rows given Arrow string/binary layout
// (int32 offsets[n+1] into a contiguous data buffer)
void hash_bytes_rows(const int32_t* offsets, const uint8_t* data, int64_t n,
                     uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = fnv1a(data + offsets[i], offsets[i + 1] - offsets[i]);
  }
}

// combine a second key column into running hashes (multi-key joins)
void hash_combine(uint64_t* acc, const uint64_t* extra, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    acc[i] = mix64(acc[i] ^ (extra[i] + 0x9e3779b97f4a7c15ULL + (acc[i] << 6) + (acc[i] >> 2)));
  }
}

// partition assignment + per-partition counts in one pass
void partition_assign(const uint64_t* hashes, int64_t n, int32_t nparts,
                      int32_t* part_of, int64_t* counts) {
  for (int32_t p = 0; p < nparts; ++p) counts[p] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t p = (int32_t)(hashes[i] % (uint64_t)nparts);
    part_of[i] = p;
    counts[p] += 1;
  }
}

// stable counting sort of row indices by partition: out_indices holds the
// row ids of partition 0, then 1, ... (offsets from the counts prefix sum)
void partition_gather(const int32_t* part_of, int64_t n, int32_t nparts,
                      const int64_t* counts, int64_t* out_indices) {
  int64_t cursor[4096];
  if (nparts > 4096) return;  // guarded in the Python wrapper
  int64_t acc = 0;
  for (int32_t p = 0; p < nparts; ++p) { cursor[p] = acc; acc += counts[p]; }
  for (int64_t i = 0; i < n; ++i) out_indices[cursor[part_of[i]]++] = i;
}

}  // extern "C"
