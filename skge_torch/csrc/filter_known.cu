// The serving filter: every known answer of each query masked in the
// (B, C) score tile, in place.
//
//   scores[b, a - base] = -1e30   for every a in answers[offsets[i]:offsets[i + 1]]
//                                 with keys[i] == ent[b] * n_relations + rel[b]
//                                 and base <= a < base + C
//
// -1e30 is skge_torch.evaluation.NEG_INF, the value the top-k reads as
// "filtered". The index is CSR over the known triples of one direction
// (skge_torch/data.py, `known_csr`): `keys` sorted and distinct, `answers`
// sorted and distinct within a key. It is built once per predictor and
// lives on the card; a batch sends only its query ids.
//
// Replaces no TPU kernel: the JAX package builds the batch's (row,
// entity) pairs on the host in Python, pads them to a power of two for
// `jit`, and scatters them. Here that host loop and its copy are gone.
//
// Design: one block per query row. Thread 0 binary-searches the row's key
// (a miss, or an entity or relation out of range, leaves the row as it
// is); the block's threads then walk the key's answers strided, each
// masking the answers that fall inside the tile's columns, so a long
// (Zipf-hot) list spreads over the block. The block adds its count of
// masked cells to `masked` (an int64 on the card; one atomic a block with
// a non-zero count) for tests that show the kernel ran; nothing on the
// serving path reads it.
//
// Bound: bytes, and tiny: a batch of 1,024 queries reads ~1,024 x 18 keys
// of the search, ~21 answers a query, and writes one 4-byte score per
// known answer (~22k cells, under 0.1 MB). Its time is the search's
// dependent loads (~18 a row, all rows of the batch in one wave), a few
// microseconds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr double kNegInf = -1e30;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    filter_known_kernel(T* __restrict__ scores, const int64_t* __restrict__ ent,
                        const int64_t* __restrict__ rel, const int64_t* __restrict__ keys,
                        const int64_t* __restrict__ offsets,
                        const int32_t* __restrict__ answers, const int64_t C,
                        const int64_t n_keys, const int64_t base, const int64_t n_relations,
                        unsigned long long* __restrict__ masked) {
  __shared__ int64_t range[2];
  __shared__ int warp_counts[kThreads / 32];
  const int64_t row = blockIdx.x;
  if (threadIdx.x == 0) {
    int64_t lo = 0, hi = 0;
    const int64_t e = ent[row], r = rel[row];
    // e above the last key's entity cannot hit (and e * n_relations could overflow)
    if (n_keys > 0 && e >= 0 && r >= 0 && r < n_relations &&
        e <= keys[n_keys - 1] / n_relations) {
      const int64_t q = e * n_relations + r;
      int64_t a = 0, b = n_keys;  // the first key >= q
      while (a < b) {
        const int64_t m = a + (b - a) / 2;
        if (keys[m] < q) {
          a = m + 1;
        } else {
          b = m;
        }
      }
      if (a < n_keys && keys[a] == q) {
        lo = offsets[a];
        hi = offsets[a + 1];
      }
    }
    range[0] = lo;
    range[1] = hi;
  }
  __syncthreads();
  const int64_t lo = range[0], hi = range[1];
  if (lo == hi) return;  // the whole block leaves together
  T* out = scores + row * C;
  int n = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int64_t c = static_cast<int64_t>(answers[i]) - base;
    if (c >= 0 && c < C) {
      out[c] = static_cast<T>(kNegInf);
      ++n;
    }
  }
  for (int s = 16; s > 0; s >>= 1) n += __shfl_down_sync(0xffffffffu, n, s);
  if (threadIdx.x % 32 == 0) warp_counts[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total > 0) atomicAdd(masked, static_cast<unsigned long long>(total));
  }
}

template <typename T>
int launch(void* scores, const void* ent, const void* rel, const void* keys,
           const void* offsets, const void* answers, int64_t B, int64_t C, int64_t n_keys,
           int64_t base, int64_t n_relations, void* masked, void* stream) {
  if (n_relations <= 0 || B > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return 0;
  filter_known_kernel<T><<<static_cast<unsigned>(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(scores), static_cast<const int64_t*>(ent),
      static_cast<const int64_t*>(rel), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(answers), C, n_keys,
      base, n_relations, static_cast<unsigned long long*>(masked));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scores (B, C) fp32 or fp64, row-major; ent, rel (B,) int64; keys (n_keys,)
// and offsets (n_keys + 1,) int64; answers int32; masked one int64. All on
// the card of `stream`.
int skge_filter_known_f32(void* scores, const void* ent, const void* rel, const void* keys,
                          const void* offsets, const void* answers, int64_t B, int64_t C,
                          int64_t n_keys, int64_t base, int64_t n_relations, void* masked,
                          void* stream) {
  return launch<float>(scores, ent, rel, keys, offsets, answers, B, C, n_keys, base,
                       n_relations, masked, stream);
}

int skge_filter_known_f64(void* scores, const void* ent, const void* rel, const void* keys,
                          const void* offsets, const void* answers, int64_t B, int64_t C,
                          int64_t n_keys, int64_t base, int64_t n_relations, void* masked,
                          void* stream) {
  return launch<double>(scores, ent, rel, keys, offsets, answers, B, C, n_keys, base,
                        n_relations, masked, stream);
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
