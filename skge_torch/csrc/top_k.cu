// The top k of a score tile: each row's k largest scores, descending, and
// their columns, ties broken toward the lower column.
//
//   vals[b, i], pos[b, i]   for i < k: the i-th of row b's n scores in the
//                           order value descending, then column ascending
//
// That is the order of `lax.top_k` and of the plain version
// (skge_torch/ops/cuda_topk.py, `top_k_reference`), bit for bit: +0.0 and
// -0.0 tie (both keyed as +0.0; the value written out is the tile's own),
// and -1e30 (the filter's NEG_INF) and -inf are values like any other. NaN
// is outside the contract: no engine makes one. With `mask` the epilogue
// of serving's single-device batch is folded in: a winner at or below
// -1e30 becomes (-inf, -1) and the ids are int32. Without it the
// positions are int64, for the sharded merge and the streamed fold to
// gather ids with.
//
// Replaces no TPU kernel: the JAX package calls `lax.top_k`, which XLA
// compiles. On the card the port ran PyTorch's radix `topk` twice, a
// `cumsum` scan, a stable `sort`, two `gather`s and some fifteen
// element-wise launches a batch.
//
// Bound: bytes. A serving batch reads a (1,024 x 14,951) fp32 tile, 61.2
// MB, and writes 82 KB: 18.3 us at 3.35 TB/s. An element costs a compare
// or two, so the design reads the tile from device memory once, coalesced,
// a block of 256 threads a row with eight loads in flight a thread (eight
// blocks resident on each of the 132 SMs: the 1,024 rows in one wave), and
// does little else:
//
// - Every key is distinct: the value's bits made monotone, above the
//   column's complement (64 bits for fp32, 96 for fp64). "The k largest
//   keys" is then the whole order, and no step has to handle ties.
// - k <= 256 (serving's k = 10): each thread takes the largest key of its
//   strided columns. The k-th largest of the block's 256 maxima (found by
//   counting, each thread the maxima above its own) has at least k keys at
//   or above it, so those keys are the candidates: a second read of the
//   row, from the L2 cache where the first read left it, keeps typically k
//   to 2k of them. Each candidate's place is the count of candidates above
//   it; up to 256 of them need no sort.
// - k > 256, or more candidates than the 2,048 slots of shared memory: an
//   exact radix select of the k-th largest key, eight bits a pass over the
//   row, then the k keys at or above it placed the same way, or sorted in
//   shared memory (bitonic) where they are more than 256. Above 2,048 the
//   places go 2,048 at a time, a select for each chunk (k = 14,951 over the
//   serve tile: 1.6 ms, where the plain version takes 6.3).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;          // loads in flight a thread in a pass over a row
constexpr int kCap = 2048;         // candidates a block sorts in shared memory
constexpr double kNegInf = -1e30;  // skge_torch.ops.cuda_filter.NEG_INF

template <typename T>
struct Order;

// fp32: a 64-bit key, (monotone value bits) << 32 | ~column
template <>
struct Order<float> {
  using Key = unsigned long long;
  static constexpr int kBits = 64;
  __device__ static Key make(float v, int64_t col) {
    unsigned b = v == 0.0f ? 0u : __float_as_uint(v);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (static_cast<Key>(b) << 32) | static_cast<Key>(~static_cast<unsigned>(col));
  }
  __device__ static int64_t column(Key k) { return ~static_cast<unsigned>(k); }
  __device__ static bool above(Key a, Key b) { return a > b; }
  __device__ static bool same(Key a, Key b) { return a == b; }
  __device__ static unsigned digit(Key k, int shift) {
    return static_cast<unsigned>(k >> shift) & 0xffu;
  }
  // k with its bits below `shift` cleared; shift <= kBits
  __device__ static Key high(Key k, int shift) {
    return shift >= 64 ? 0ull : k & ~((1ull << shift) - 1);
  }
  __device__ static Key with_digit(Key k, unsigned d, int shift) {
    return k | (static_cast<Key>(d) << shift);
  }
  __device__ static Key least() { return 0ull; }  // below every key of a column
  __device__ static float neg_inf() { return __int_as_float(0xff800000); }
};

// fp64: a 96-bit key, the monotone value bits above ~column
struct Key96 {
  unsigned long long v;
  unsigned c;
};

template <>
struct Order<double> {
  using Key = Key96;
  static constexpr int kBits = 96;
  __device__ static Key make(double v, int64_t col) {
    unsigned long long b =
        v == 0.0 ? 0ull : static_cast<unsigned long long>(__double_as_longlong(v));
    b = (b >> 63) ? ~b : (b | (1ull << 63));
    return {b, ~static_cast<unsigned>(col)};
  }
  __device__ static int64_t column(Key k) { return ~k.c; }
  __device__ static bool above(Key a, Key b) { return a.v > b.v || (a.v == b.v && a.c > b.c); }
  __device__ static bool same(Key a, Key b) { return a.v == b.v && a.c == b.c; }
  __device__ static unsigned digit(Key k, int shift) {
    return shift >= 32 ? static_cast<unsigned>(k.v >> (shift - 32)) & 0xffu
                       : (k.c >> shift) & 0xffu;
  }
  __device__ static Key high(Key k, int shift) {
    if (shift >= 96) return {0ull, 0u};
    if (shift >= 32) return {k.v & ~((1ull << (shift - 32)) - 1), 0u};
    return {k.v, k.c & ~((1u << shift) - 1)};
  }
  __device__ static Key with_digit(Key k, unsigned d, int shift) {
    if (shift >= 32) return {k.v | (static_cast<unsigned long long>(d) << (shift - 32)), k.c};
    return {k.v, k.c | (d << shift)};
  }
  __device__ static Key least() { return {0ull, 0u}; }
  __device__ static double neg_inf() { return __longlong_as_double(0xfff0000000000000ll); }
};

// f(value, column) for each column this thread owns in a row of n: t,
// t + 256, ..., with kLoads loads in flight
template <typename T, typename F>
__device__ __forceinline__ void each(const T* __restrict__ row, const int64_t n, F&& f) {
  int64_t j = threadIdx.x;
  for (; j + (kLoads - 1) * kThreads < n; j += kLoads * kThreads) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = row[j + u * kThreads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) f(v[u], j + u * kThreads);
  }
  for (; j < n; j += kThreads) f(row[j], j);
}

// Sorts a[0, len) descending, len a power of two: the bitonic network, a
// stride a step; the block's threads all call it.
template <typename O, typename Key>
__device__ void sort_descending(Key* a, const int len) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1)), l = i + stride;
        const Key x = a[i], y = a[l];
        if ((i & size) == 0 ? O::above(y, x) : O::above(x, y)) {
          a[i] = y;
          a[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool kMask>
__device__ __forceinline__ void put(const T* __restrict__ row, const int64_t col,
                                    const int64_t at, T* __restrict__ vals, void* pos) {
  const T v = row[col];
  if (kMask) {
    const bool bad = v <= static_cast<T>(kNegInf);
    vals[at] = bad ? Order<T>::neg_inf() : v;
    static_cast<int32_t*>(pos)[at] = bad ? -1 : static_cast<int32_t>(col);
  } else {
    vals[at] = v;
    static_cast<int64_t*>(pos)[at] = col;
  }
}

// The k-th largest key of the row: exactly k keys lie at or above it.
// Eight bits a pass from the top, each pass a histogram of the next digit
// among the keys that share the digits found so far; it stops once every
// key of the chosen digit is among the k.
template <typename T>
__device__ typename Order<T>::Key radix_select(const T* __restrict__ row, const int64_t n,
                                               const int k, unsigned* hist) {
  using O = Order<T>;
  using Key = typename O::Key;
  __shared__ unsigned digit_s;
  __shared__ int need_s;
  __shared__ bool done_s;
  const int lane = threadIdx.x % 32;
  Key prefix = O::least();
  int need = k;
  for (int shift = O::kBits - 8; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    // the same trip count for every thread, so each warp's lanes match up
    for (int64_t j0 = 0; j0 < n; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      unsigned d = 256;  // no bin
      if (j < n) {
        const Key key = O::make(row[j], j);
        if (O::same(O::high(key, shift + 8), prefix)) d = O::digit(key, shift);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < 256 && __ffs(peers) - 1 == lane) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned d = 255, above = 0;
      while (above + hist[d] < static_cast<unsigned>(need)) above += hist[d--];
      digit_s = d;
      need_s = need - static_cast<int>(above);
      done_s = hist[d] == static_cast<unsigned>(need_s);
    }
    __syncthreads();
    prefix = O::with_digit(prefix, digit_s, shift);
    need = need_s;
    const bool done = done_s;
    __syncthreads();  // every thread has read them before they change
    if (done) break;
  }
  return prefix;
}

// The first k of the m candidates cand[0, m), in the total order, written
// from slot `at` on: each candidate's place is the count of candidates above
// it, or, for more than a block's threads, a sort. The block's threads all
// call it.
template <typename T, bool kMask, typename Key>
__device__ void place(Key* cand, const int m, const int k, const T* __restrict__ row,
                      const int64_t at, T* __restrict__ vals, void* pos) {
  using O = Order<T>;
  if (m <= kThreads) {
    if (threadIdx.x < m) {
      const Key mine = cand[threadIdx.x];
      int above = 0;
      for (int i = 0; i < m; ++i) above += O::above(cand[i], mine);
      if (above < k) put<T, kMask>(row, O::column(mine), at + above, vals, pos);
    }
    return;
  }
  int len = 1;
  while (len < m) len <<= 1;
  for (int i = m + threadIdx.x; i < len; i += kThreads) cand[i] = O::least();
  __syncthreads();
  sort_descending<O>(cand, len);
  for (int i = threadIdx.x; i < k; i += kThreads)
    put<T, kMask>(row, O::column(cand[i]), at + i, vals, pos);
}

// One block a row; 32 registers a thread let eight fp32 blocks share an SM.
template <typename T, bool kMask>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 8 : 4)
    top_k_kernel(const T* __restrict__ scores, const int64_t n, const int k,
                 T* __restrict__ vals, void* __restrict__ pos) {
  using O = Order<T>;
  using Key = typename O::Key;
  __shared__ Key cand[kCap];
  __shared__ unsigned hist[256];
  __shared__ int count;
  __shared__ Key bound_s;
  const T* row = scores + static_cast<int64_t>(blockIdx.x) * n;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * k;
  if (k <= kThreads) {
    T best = 0;
    int64_t col = -1;
    each(row, n, [&](const T v, const int64_t j) {
      if (col < 0 || v > best) {  // strict: the lowest column of equal values
        best = v;
        col = j;
      }
    });
    const Key mine = col < 0 ? O::least() : O::make(best, col);
    cand[threadIdx.x] = mine;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    // the bound is the maximum with k - 1 maxima above it: a column's key,
    // since n >= k columns have owners, and keys are distinct
    int above = 0;
    for (int i = 0; i < kThreads; ++i) above += O::above(cand[i], mine);
    if (above == k - 1) bound_s = mine;
    __syncthreads();
    const Key bound = bound_s;
    const T bound_v = row[O::column(bound)];
    each(row, n, [&](const T v, const int64_t j) {
      if (v >= bound_v) {
        const Key key = O::make(v, j);
        if (!O::above(bound, key)) {
          const int s = atomicAdd(&count, 1);
          if (s < kCap) cand[s] = key;
        }
      }
    });
    __syncthreads();
    const int m = count;
    if (m <= kCap) {
      place<T, kMask>(cand, m, k, row, at, vals, pos);
      return;
    }
  }
  // exact: kCap places at a time, [lo, lo + c) the keys below the last
  // chunk's and at or above the (lo + c)-th largest
  Key upper = O::least();
  for (int lo = 0; lo < k; lo += kCap) {
    const int c = k - lo < kCap ? k - lo : kCap;
    const Key bound = radix_select(row, n, lo + c, hist);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    each(row, n, [&](const T v, const int64_t j) {
      const Key key = O::make(v, j);
      if (!O::above(bound, key) && (lo == 0 || O::above(upper, key)))
        cand[atomicAdd(&count, 1)] = key;
    });
    __syncthreads();
    place<T, kMask>(cand, c, c, row, at + lo, vals, pos);
    upper = bound;
    __syncthreads();  // the chunk is written before the next one fills cand
  }
}

template <typename T>
int launch(const void* scores, int64_t B, int64_t n, int64_t k, int mask, void* vals,
           void* pos, void* stream) {
  if (B < 0 || B > 0x7fffffff || n < 1 || n > 0x7fffffff || k < 1 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto kernel = mask ? top_k_kernel<T, true> : top_k_kernel<T, false>;
  kernel<<<static_cast<unsigned>(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(scores), n, static_cast<int>(k), static_cast<T*>(vals), pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scores (B, n) fp32 or fp64, row-major; vals (B, k) of the same type;
// pos (B, k) int32 with mask, int64 without. All on the card of `stream`.
int skge_top_k_f32(const void* scores, int64_t B, int64_t n, int64_t k, int mask, void* vals,
                   void* pos, void* stream) {
  return launch<float>(scores, B, n, k, mask, vals, pos, stream);
}

int skge_top_k_f64(const void* scores, int64_t B, int64_t n, int64_t k, int mask, void* vals,
                   void* pos, void* stream) {
  return launch<double>(scores, B, n, k, mask, vals, pos, stream);
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
