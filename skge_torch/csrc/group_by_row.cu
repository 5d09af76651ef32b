// Group by row: a stable order of T occurrences by their row id, and the
// start of every row's run in it.
//
// Replaces no TPU kernel. The TPU kernels `segment_sum_pallas`
// (skge_tpu/ops/pallas_segment.py) and `segment_outer_sum_pallas`
// (skge_tpu/ops/pallas_outer.py) walk the occurrences in order on one
// core; their Hopper ports (segment_sum.cu's deterministic variant and
// segment_outer_sum.cu) give each row to its own warps instead, and so
// need the occurrences grouped by row first, each row's in their order.
// This is that index preparation. Its output is what a stable sort of the
// ids gives, and a binary search of each row id in the sorted ids:
//
//   keys (T,) int32: the ids clamped to [-1, R], ascending;
//   perm (T,):       the positions in that order, ties in position order;
//   offsets (R + 1): offsets[r] = the number of keys < r, so that
//                    perm[offsets[r]:offsets[r + 1]] are the positions of
//                    id r, in order. Ids < 0 sort before offsets[0], ids
//                    >= R after offsets[R].
//
// perm and offsets are int32 or int64 (the caller's choice: the segment
// sum reads int32, the segment outer sum int64).
//
// Design. T is small on every path that groups (a few thousand to ~20,000
// occurrences: one training step's ids), and a library sort spends its time
// in launches (a histogram, a scan, one pass a byte of the key, an index
// fill: ~30 us at T = 4,832 on an H100, for ~40 KB of ids). Three launches
// here:
// 1. Tiles of kTile = 2,048 items, a block of 512 threads each, are sorted
//    stably in shared memory: an LSD radix sort over the bits that ids up
//    to R + 1 need (14 at 14,951 rows, 19 at 505,128), in passes of up to
//    8 bits. Each warp holds a contiguous range of the tile, 4 items a
//    lane, in registers (512 threads of 4 beat 256 of 8: 6.8 against 9.4
//    us at T = 10,688 on an H100). A pass counts each warp's digits (shared
//    atomics), scans the digit-major, warp-minor counts, then each warp
//    walks its items in order, 32 at a time: lanes with the same digit
//    find each other with one ballot a digit bit, so an item's place is
//    its warp's running count for the digit plus the lanes of the same
//    digit before it. Every pass is stable, so ties keep their positions'
//    order.
// 2. Merge by rank, a thread an item: its place in the whole order is its
//    place in its tile plus, for every other tile, the number of its keys
//    below the item's (a binary search, 8 tiles' searches in lockstep):
//    keys equal to it count in the tiles before its own and not in those
//    after, which keeps the order stable. A single tile writes the outputs
//    itself and skips this launch. The probes go to L2 (~8 us at T =
//    10,688); copying all keys to each block's shared memory first saved
//    ~1 us there and lost 20 us at T = 49,152, so the copy is not made.
// 3. Each row's start, by a binary search in the sorted keys, a thread a
//    row.
// A first version sorted all of T in one block of 512 threads, 40 items a
// lane in registers: ~800 cycles a 32-item step and ~4 us a pass even at
// T = 64 on an H100 (30 us at T = 10,688), on one SM with nothing else to
// hide its stalls. Lanes found their peers with __match_any_sync there;
// ballots instead saved only ~10%.
//
// Bound. 8*T bytes in, 4*T + 4 or 8 * (T + R + 1) out: at T = 10,688 about
// 0.15 MB, under a microsecond at the HBM rate. The tiles' passes and the
// merge's searches (log2(kTile) = 11 dependent loads a tile) and the
// offsets' (log2(T)) bound it, not the bytes.
//
// Any T < 2^31 - 1 is taken, but the merge's work grows as T^2 / kTile:
// an item searches every other tile (9 at T = 19,328, the most any path
// of the port groups; 489 at T = 10^6, where a merge tree would do
// better). T = 0 launches only the offsets, all 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;                 // a tile's block
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 4;                     // items a lane holds
constexpr int kTile = kThreads * kIters;      // 2,048
constexpr int kDigitBits = 8;
constexpr int kCounts = kWarps << kDigitBits;
constexpr unsigned kFull = 0xffffffffu;

// the digit-count slot of entry e, skewed by one every 32 so that the scan's
// contiguous runs a thread fall on distinct banks
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// Exclusive scan, in place, of the n digit-major counts in cnt.
__device__ void exclusive_scan(uint32_t* cnt, int n, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n), hi = min(lo + per, n);
  uint32_t own = 0;
  for (int e = lo; e < hi; ++e) own += cnt[slot(e)];
  uint32_t incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const uint32_t v = lane < kWarps ? warp_sums[lane] : 0;
    uint32_t s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += u;
    }
    if (lane < kWarps) warp_sums[lane] = s - v;
  }
  __syncthreads();
  uint32_t run = warp_sums[w] + incl - own;
  for (int e = lo; e < hi; ++e) {
    const uint32_t v = cnt[slot(e)];
    cnt[slot(e)] = run;
    run += v;
  }
}

// Block b sorts items [b*kTile, b*kTile + kTile) of T by key, stably. With
// one tile it writes keys_out and perm_out; else its tile of tkeys, tpos.
template <typename P>
__global__ void __launch_bounds__(kThreads)
    sort_tiles_kernel(const int64_t* __restrict__ idx, const int64_t T, const int64_t R,
                      const int bits, const int passes, int32_t* __restrict__ tkeys,
                      int32_t* __restrict__ tpos, int32_t* __restrict__ keys_out,
                      P* __restrict__ perm_out) {
  __shared__ uint32_t cnt[kCounts + kCounts / 32];
  __shared__ uint2 buf[kTile];
  __shared__ uint32_t warp_sums[kWarps];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile;
  const int n = static_cast<int>(lmin(kTile, T - first));
  const int db = (bits + passes - 1) / passes;
  const int counts = kWarps << db;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int iters = (n + kThreads - 1) / kThreads;  // a lane's items
  const int base = w * iters * 32;                   // the warp's first item
  const unsigned below = (1u << lane) - 1;

  uint32_t key[kIters], pos[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int q = base + i * 32 + lane;
    if (i < iters && q < n) {
      const int64_t v = idx[first + q];
      key[i] = static_cast<uint32_t>((v < 0 ? -1 : (v > R ? R : v)) + 1);
      pos[i] = static_cast<uint32_t>(first + q);
    }
  }
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * db;
    const uint32_t mask = (1u << db) - 1;
    for (int e = threadIdx.x; e < counts; e += kThreads) cnt[slot(e)] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int q = base + i * 32 + lane;
      if (i < iters && q < n) {
        atomicAdd(&cnt[slot(((key[i] >> shift) & mask) * kWarps + w)], 1u);
      }
    }
    __syncthreads();
    exclusive_scan(cnt, counts, warp_sums);
    __syncthreads();
    // each warp places its items in order: a running count a digit
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      if (i < iters) {  // the same for every lane
        const int q = base + i * 32 + lane;
        const bool valid = q < n;
        const unsigned active = __ballot_sync(kFull, valid);
        if (valid) {
          const uint32_t d = (key[i] >> shift) & mask;
          unsigned peers = active;
          for (int b = 0; b < db; ++b) {
            const bool one = (d >> b) & 1;
            const unsigned m = __ballot_sync(active, one);
            peers &= one ? m : ~m;
          }
          uint32_t* c = &cnt[slot(d * kWarps + w)];
          const uint32_t at = *c;
          buf[at + __popc(peers & below)] = make_uint2(key[i], pos[i]);
          __syncwarp(active);
          if (lane == __ffs(peers) - 1) *c = at + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (pass + 1 < passes) {
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int q = base + i * 32 + lane;
        if (i < iters && q < n) {
          const uint2 item = buf[q];
          key[i] = item.x;
          pos[i] = item.y;
        }
      }
      __syncthreads();
    }
  }
  const bool whole = gridDim.x == 1;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const uint2 item = buf[q];
    const int32_t k = static_cast<int32_t>(item.x) - 1;
    if (whole) {
      keys_out[q] = k;
      perm_out[q] = static_cast<P>(item.y);
    } else {
      tkeys[first + q] = k;
      tpos[first + q] = static_cast<int32_t>(item.y);
    }
  }
}

// Item j of the sorted tiles to its place in the whole order. The searches
// of kProbe tiles go in lockstep: kProbe independent loads a round.
template <typename P>
__global__ void merge_kernel(const int32_t* __restrict__ tkeys,
                             const int32_t* __restrict__ tpos, const int64_t T,
                             int32_t* __restrict__ keys_out, P* __restrict__ perm_out) {
  constexpr int kProbe = 8;
  constexpr int kRounds = 12;  // ceil(log2(kTile + 1)): a range of kTile halves to 0
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= T) return;
  const int64_t a = j / kTile, tiles = (T + kTile - 1) / kTile;
  const int32_t k = tkeys[j];
  int64_t at = j - a * kTile;
  for (int64_t b0 = 0; b0 < tiles; b0 += kProbe) {
    int64_t lo[kProbe], hi[kProbe], start[kProbe];
#pragma unroll
    for (int u = 0; u < kProbe; ++u) {
      const int64_t b = b0 + u;
      const bool other = b < tiles && b != a;
      lo[u] = start[u] = other ? b * kTile : 0;
      hi[u] = other ? lmin(lo[u] + kTile, T) : 0;
    }
    // keys equal to k count in the tiles before a, not in those after
#pragma unroll
    for (int round = 0; round < kRounds; ++round) {
#pragma unroll
      for (int u = 0; u < kProbe; ++u) {
        if (lo[u] < hi[u]) {
          const int64_t mid = (lo[u] + hi[u]) >> 1;
          const int32_t v = tkeys[mid];
          if (v < k || (v == k && b0 + u < a)) {
            lo[u] = mid + 1;
          } else {
            hi[u] = mid;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kProbe; ++u) at += lo[u] - start[u];
  }
  keys_out[at] = k;
  perm_out[at] = static_cast<P>(tpos[j]);
}

// offsets[r] = the number of keys < r, r in [0, R]: a binary search a row.
template <typename O>
__global__ void offsets_kernel(const int32_t* __restrict__ keys, const int64_t T,
                               const int64_t R, O* __restrict__ offsets) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r <= R; r += stride) {
    int64_t lo = 0, hi = T;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < r) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    offsets[r] = static_cast<O>(lo);
  }
}

template <typename O>
cudaError_t launch_offsets(const int32_t* keys, int64_t T, int64_t R, void* offsets,
                           cudaStream_t s) {
  int64_t blocks = (R + 1 + 255) / 256;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  offsets_kernel<O><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      keys, T, R, static_cast<O*>(offsets));
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_sort(const int64_t* idx, int64_t T, int64_t R, int32_t* tkeys,
                        int32_t* tpos, int32_t* keys, void* perm, cudaStream_t s) {
  int bits = 1;
  while ((static_cast<int64_t>(1) << bits) <= R + 1) ++bits;  // keys lie in [0, R + 1]
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int64_t tiles = (T + kTile - 1) / kTile;
  sort_tiles_kernel<P><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      idx, T, R, bits, passes, tkeys, tpos, keys, static_cast<P*>(perm));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  merge_kernel<P><<<static_cast<unsigned>((T + 255) / 256), 256, 0, s>>>(
      tkeys, tpos, T, keys, static_cast<P*>(perm));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// idx (T,) int64 on the card; keys (T,) int32, perm (T,) and offsets
// (R + 1,) written, int64 where wide != 0, else int32; scratch: 2*T int32
// (read and written only where T > kTile). 0 <= T < 2^31 - 1,
// 0 < R < 2^31 - 1. Launches its kernels on `stream`; returns
// cudaGetLastError() after each (0 when all launched).
int skge_group_by_row(const void* idx, int64_t T, int64_t R, void* keys, void* perm,
                      void* offsets, void* scratch, int wide, void* stream) {
  if (T < 0 || T >= 0x7fffffff || R <= 0 || R >= 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int64_t*>(idx);
  auto* k = static_cast<int32_t*>(keys);
  auto* tkeys = static_cast<int32_t*>(scratch);
  if (T > 0) {
    const cudaError_t err =
        wide ? launch_sort<int64_t>(i, T, R, tkeys, tkeys + T, k, perm, s)
             : launch_sort<int32_t>(i, T, R, tkeys, tkeys + T, k, perm, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = wide ? launch_offsets<int64_t>(k, T, R, offsets, s)
                               : launch_offsets<int32_t>(k, T, R, offsets, s);
  return static_cast<int>(err);
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
