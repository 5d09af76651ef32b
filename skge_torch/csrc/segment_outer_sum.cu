// Segment outer sum: out[r] = the in-order sum, over the occurrences t with
// idx[t] == r, of sum_f u_f[t] (x) v_f[t], into an (R, d, d) table.
//
// Replaces the TPU kernel `segment_outer_sum_pallas` in
// skge_tpu/ops/pallas_outer.py (body `_kernel`). It is RESCAL's W-gradient
// scatter under the dense aggregate modes: each positive's W gradient is the
// rank-2 sum es (x) dq + dr (x) eo, handed over as its (T, d) factors, so the
// (T, d, d) outer products never exist in device memory.
//
// Contract (the TPU kernel's): all rank terms of one occurrence are summed
// before the table add; ids < 0 or >= R are dropped, and negative ids do not
// wrap. fp32 only, rank <= kMaxRank. Every cell of `out` is written (zeros
// where no occurrence lands), so the caller does not zero-fill it.
//
// Input. The wrapper groups the occurrences by row before the launch:
// `perm` is a stable ascending order of the ids, `offsets` (R + 1) the
// start of each row's run in it; dropped ids sort outside
// [offsets[0], offsets[R]).
//
// Design. The TPU kernel keeps the table in VMEM and walks the occurrences
// in order, one read-modify-write table[r] += sum_f u_f (x) v_f each. Here
// one block owns one kTile x kTile tile of a few consecutive rows of the
// table, and each of its threads kCell x kCell cells of the tile. The block
// walks those rows' runs, which lie back to back in `perm`, as one stream,
// in order: the sum of every cell is the TPU's, bit for bit. At the end of
// a row's run it stores its cells of W_r and starts again from zero, so
// the table is written once, with no atomics and no zero-fill. The block
// stages the stream in chunks of occurrences (the tile's slices of each
// u_f and v_f) in shared memory with cp.async, in a ring of kStages
// chunks, ids from `perm` a ring further ahead. Products and sums are
// rounded one at a time (__fmul_rn / __fadd_rn: no FMA contraction), as
// the TPU rounds them.
//
// Which rows a block walks follows from each row's own length, read on the
// card: row r starts at key(r) = offsets[r] + r, a place in the stream of
// every occurrence and every row, and window g of that stream, keys
// [g * kWindow, (g + 1) * kWindow), holds the rows that start in it. So a
// block walks at most kWindow rows and kWindow occurrences, besides one
// row that starts in its window and runs on: many short rows (FB15k's
// 1,345 relations, ~3.6 occurrences each) share a block and its round
// trips, and two long rows never share one, whatever their ids. The
// windows that a long row covers hold no row start; when it covers more
// than kParts + 1 of them, the blocks of the first kParts after its own
// walk it instead, each one slab of kTile / kParts rows of the tile, one
// cell a thread: four times the threads on its serial chains, each with a
// quarter of the work an occurrence. Windows with nothing to walk end at
// once.
//
// Sizes. Tiles of 20 x 20 keep the slices staged an occurrence small (2 *
// rank * 20 floats) and spread one W_r over 25 blocks at d = 100; 2 x 2
// cells a thread is 100 threads, 4 warps with 28 lanes idle in the last.
// On an H100 that beat 1 x 2 (200 threads) and 1 x 4 cells a thread;
// tiles of 50 whole rows of W_r with 8 x 4 cells a thread, a little faster
// on short rows, were 3x slower on a row of thousands of occurrences. A
// chunk holds 128 / rank occurrences, two chunks in the ring: on a long
// row the block's own warps issue each chunk's copies (about 20 an
// occurrence), and that cost falls per chunk, so two large chunks beat
// four of half the size there and cost nothing on FB15k's short rows,
// whose window fits one chunk.
//
// Bound. The table write, R*d*d*4 bytes (53.8 MB at FB15k's 1,345
// relations, d = 100: 16 us at 3.35 TB/s), beside 2*rank*T*d*4 bytes of
// factors read and 2*rank*T*d*d flops (193 MFLOP at T = 4,832: 2.9 us at
// the fp32 rate). Under that memory bound tensor cores buy nothing, and
// TF32 would give up fp32 parity, so the kernel uses none. A row with many
// occurrences is a serial chain of adds per cell, as on the TPU; its time
// is that of the chain.
//
// Offsets are 64-bit: r*d*d reaches past 2^31 for wide tables.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxRank = 4;
constexpr int kTile = 20;     // a tile: kTile x kTile cells of one W_r
constexpr int kCell = 2;      // a thread holds kCell x kCell cells of it
constexpr int kThreads = (kTile / kCell) * (kTile / kCell);  // 100
constexpr int kParts = 4;     // a long row's tile: kParts slabs of rows
constexpr int kSlab = kTile / kParts;
constexpr int kStages = 2;     // chunks in the shared-memory ring
constexpr int kRingOcc = 128;  // occurrences a chunk holds at rank 1
constexpr int kWindow = 64;    // keys (rows and occurrences) a window
constexpr int kUnroll = 16;    // occurrences a thread's loop unrolls
static_assert(kTile % 4 == 0 && kTile % kCell == 0, "16-byte slices, whole cells");
static_assert(kSlab * kTile == kThreads, "a slab: one cell a thread");

struct Factors {
  const float* u[kMaxRank];
  const float* v[kMaxRank];
};

template <int kRank>
struct Shared {
  static constexpr int kChunk = kRingOcc / kRank;   // occurrences a chunk
  static constexpr int kOcc = 2 * kRank * kTile;    // floats: u slices, then v
  float buf[kStages][kChunk][kOcc];
  int64_t ids[2 * kStages][kChunk];
  int64_t off[kWindow + 1];  // the runs of the rows walked
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     shared_address(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     shared_address(dst)),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// N neighbouring floats at p (aligned to N floats) in one load or store.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&x)[N]) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&x)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// The counts #{r < R : key(r) < target[k]}, k = 0, 1, for every thread of
// the block: keys rise with r, so each round probes kThreads evenly spaced
// rows of the range left and keeps the stretch between the last probe
// below the target and the first one not.
__device__ __forceinline__ void rows_before(const int64_t* __restrict__ offsets,
                                            const int64_t R,
                                            const int64_t (&target)[2],
                                            int64_t (&count)[2]) {
  int64_t lo[2] = {0, 0}, hi[2] = {R, R};  // count[k] lies in [lo[k], hi[k]]
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t step = (hi[k] - lo[k] + kThreads - 1) / kThreads;
      const int64_t q = lo[k] + threadIdx.x * step;
      const bool below = q < hi[k] && offsets[q] + q < target[k];
      const int64_t n = __syncthreads_count(below);
      if (n == 0) {
        hi[k] = lo[k];
      } else {
        const int64_t first = lo[k];
        lo[k] = first + (n - 1) * step + 1;
        hi[k] = hi[k] < first + n * step ? hi[k] : first + n * step;
      }
    }
  }
  count[0] = lo[0];
  count[1] = lo[1];
}

// Copies `len` floats at column `col` of the factor rows ids[0 .. m) of
// each src[s] to dst + e * kOcc + s * kLen, kWidth floats a copy.
template <int kRank, int kWidth, int kLen>
__device__ __forceinline__ void stage_slices(const float* const (&src)[kMaxRank],
                                             const int64_t* ids, int m, int d,
                                             int col, int len, float* dst) {
  constexpr int kPieces = kLen / kWidth;
  constexpr int kOcc = Shared<kRank>::kOcc;
  for (int w = threadIdx.x; w < m * kPieces; w += kThreads) {
    const int e = w / kPieces;
    const int x = (w - e * kPieces) * kWidth;
    if (x >= len) continue;
    const int64_t at = ids[e] * d + col + x;
#pragma unroll
    for (int s = 0; s < kRank; ++s) {
      cp_async<4 * kWidth>(dst + e * kOcc + s * kLen + x, src[s] + at);
    }
  }
}

// The block walks rows r0 .. r0 + nrows - 1 (their runs bound in sh.off)
// in order, for cells i0 + [0, nu) by j0 + [0, nv) of their W_r, kRows x
// kCols of them a thread; kURows rows of u are staged an occurrence. vec:
// d % 4 == 0 and 16-byte aligned factors and table.
template <int kRank, int kRows, int kCols, int kURows>
__device__ __forceinline__ void walk(Shared<kRank>& sh,
                                     const int64_t* __restrict__ perm,
                                     const Factors& f, float* __restrict__ out,
                                     const int d, const int64_t r0,
                                     const int nrows, const int i0, const int nu,
                                     const int j0, const int nv, const bool vec) {
  constexpr int kChunk = Shared<kRank>::kChunk;
  constexpr int kOcc = Shared<kRank>::kOcc;
  constexpr int kV = (kRank * kURows + 3) / 4 * 4;  // where the v slices start
  const int tid = static_cast<int>(threadIdx.x);
  const int i = tid / (kTile / kCols) * kRows;  // the thread's first cell
  const int j = tid % (kTile / kCols) * kCols;
  const int64_t begin = sh.off[0];
  const int64_t count = sh.off[nrows] - begin;
  const int64_t nchunks = (count + kChunk - 1) / kChunk;

  auto in_chunk = [&](int64_t c) {
    const int64_t left = count - c * kChunk;
    return left < kChunk ? static_cast<int>(left) : kChunk;
  };
  auto stage_ids = [&](int64_t c) {
    if (c >= nchunks) return;
    int64_t* dst = sh.ids[c % (2 * kStages)];
    const int64_t* src = perm + begin + c * kChunk;
    for (int e = tid; e < in_chunk(c); e += kThreads) cp_async<8>(dst + e, src + e);
  };
  // needs chunk c's ids in shared memory
  auto stage_factors = [&](int64_t c) {
    if (c >= nchunks) return;
    const int64_t* ids = sh.ids[c % (2 * kStages)];
    float* dst = &sh.buf[c % kStages][0][0];
    const int m = in_chunk(c);
    if constexpr (kURows % 4 == 0) {
      if (vec) {
        stage_slices<kRank, 4, kURows>(f.u, ids, m, d, i0, nu, dst);
      } else {
        stage_slices<kRank, 1, kURows>(f.u, ids, m, d, i0, nu, dst);
      }
    } else {
      stage_slices<kRank, 1, kURows>(f.u, ids, m, d, i0, nu, dst);
    }
    if (vec) {
      stage_slices<kRank, 4, kTile>(f.v, ids, m, d, j0, nv, dst + kV);
    } else {
      stage_slices<kRank, 1, kTile>(f.v, ids, m, d, j0, nv, dst + kV);
    }
  };

  float acc[kRows][kCols] = {};
  int row = 0;                          // of the rows walked
  int64_t row_end = sh.off[1] - begin;  // its run's end in the stream
  auto store_row = [&]() {              // the row's cells, then start again
    float* dst = out + ((r0 + row) * d + i0 + i) * static_cast<int64_t>(d) + j0 + j;
#pragma unroll
    for (int a = 0; a < kRows; ++a, dst += d) {
      if (i + a < nu) {
        if (vec && j < nv) {
          store(dst, acc[a]);
        } else {
#pragma unroll
          for (int b = 0; b < kCols; ++b) {
            if (j + b < nv) dst[b] = acc[a][b];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kCols; ++b) acc[a][b] = 0.f;
    }
  };

  // Group c holds chunk c's factors and chunk c + kStages - 1's ids, so
  // the ids of a chunk are in before its factors are asked for.
  for (int c = 0; c < kStages - 1; ++c) stage_ids(c);
  cp_async_commit();  // wait_group waits on committed groups only
  cp_async_wait<0>();
  __syncthreads();
  for (int c = 0; c < kStages - 1; ++c) {
    stage_factors(c);
    stage_ids(c + kStages - 1);
    cp_async_commit();
  }
  for (int64_t c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // group c is in
    __syncthreads();               // ... for every thread; chunk c - 1 is done
    stage_factors(c + kStages - 1);
    stage_ids(c + 2 * kStages - 2);
    cp_async_commit();             // possibly empty: the count stays uniform
    const float(*buf)[kOcc] = sh.buf[c % kStages];
    const int m = in_chunk(c);
    const int64_t first = c * kChunk;  // the chunk's place in the stream
    int e = 0;
    while (e < m) {
      while (first + e >= row_end) {  // rows that end here, empty ones too
        store_row();
        ++row;
        row_end = sh.off[row + 1] - begin;
      }
      const int stop = row_end - first < m ? static_cast<int>(row_end - first) : m;
#pragma unroll kUnroll
      for (; e < stop; ++e) {
        const float* o = buf[e];
        float u[kRank][kRows], v[kRank][kCols];
#pragma unroll
        for (int s = 0; s < kRank; ++s) {
          load(o + s * kURows + i, u[s]);
          load(o + kV + s * kTile + j, v[s]);
        }
        // the TPU's rounding: each product, then the rank sum, then the add
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
#pragma unroll
          for (int b = 0; b < kCols; ++b) {
            float delta = __fmul_rn(u[0][a], v[0][b]);
#pragma unroll
            for (int s = 1; s < kRank; ++s) {
              delta = __fadd_rn(delta, __fmul_rn(u[s][a], v[s][b]));
            }
            acc[a][b] = __fadd_rn(acc[a][b], delta);
          }
        }
      }
    }
  }
  for (; row < nrows; ++row) store_row();  // the last run's row, then empty rows
}

// One block: tile (i0, j0) of the rows that start in window g, or one slab
// of it for the long row that covers the window.
template <int kRank>
__global__ void __launch_bounds__(kThreads)
    segment_outer_sum_f32_kernel(const int64_t* __restrict__ perm,
                                 const int64_t* __restrict__ offsets,
                                 const Factors f, float* __restrict__ out,
                                 const int d, const int64_t R,
                                 const int tiles_side, const bool vec) {
  __shared__ __align__(16) Shared<kRank> sh;
  const int tiles = tiles_side * tiles_side;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int64_t g = blockIdx.x / tiles;
  const int i0 = tile / tiles_side * kTile;
  const int j0 = tile % tiles_side * kTile;
  const int nu = min(kTile, d - i0);  // valid rows of the tile
  const int nv = min(kTile, d - j0);  // valid columns of the tile
  // a row is long when its keys reach kParts + 1 windows past its own
  auto parts_of = [&](int64_t r, int64_t& start_window) {
    const int64_t start = offsets[r] + r, end = offsets[r + 1] + r + 1;
    start_window = start / kWindow;
    return (end - 1) / kWindow - start_window > kParts;
  };
  const int64_t window[2] = {g * kWindow, (g + 1) * kWindow};
  int64_t rows[2];
  rows_before(offsets, R, window, rows);
  int64_t r0 = rows[0];
  int nrows = static_cast<int>(rows[1] - rows[0]);  // <= kWindow
  int64_t g0;
  if (nrows == 0) {  // inside the row r0 - 1, if any: a slab of it, or nothing
    if (r0 == 0 || !parts_of(r0 - 1, g0) || g - g0 > kParts) return;
    const int part = static_cast<int>(g - g0 - 1);
    const int slab_rows = max(0, min(kSlab, nu - part * kSlab));
    if (threadIdx.x == 0) {
      sh.off[0] = offsets[r0 - 1];
      sh.off[1] = offsets[r0];
    }
    __syncthreads();
    if (slab_rows > 0) {
      walk<kRank, 1, 1, kSlab>(sh, perm, f, out, d, r0 - 1, 1, i0 + part * kSlab,
                               slab_rows, j0, nv, vec);
    }
    return;
  }
  if (parts_of(r0 + nrows - 1, g0)) --nrows;  // the last row: walked in slabs
  for (int x = threadIdx.x; x <= nrows; x += kThreads) sh.off[x] = offsets[r0 + x];
  __syncthreads();
  if (nrows > 0) {
    walk<kRank, kCell, kCell, kTile>(sh, perm, f, out, d, r0, nrows, i0, nu, j0, nv, vec);
  }
}

template <int kRank>
cudaError_t launch(const int64_t* perm, const int64_t* offsets,
                   const Factors& f, float* out, int64_t T, int d, int64_t R,
                   bool vec, cudaStream_t stream) {
  const int tiles_side = (d + kTile - 1) / kTile;
  // keys lie below T + R: every occurrence, dropped or kept, and the rows
  const int64_t windows = (T + R + kWindow - 1) / kWindow;
  const int64_t blocks = windows * tiles_side * tiles_side;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  segment_outer_sum_f32_kernel<kRank>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          perm, offsets, f, out, d, R, tiles_side, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// perm (T,) and offsets (R + 1,): int64, the grouping above. us, vs: host
// arrays of `rank` device pointers to (T, d) fp32 factors. out: (R, d, d),
// every cell written. Launches on `stream`; returns cudaGetLastError() (0
// when launched).
int skge_segment_outer_sum_f32(const void* perm, const void* offsets,
                               const void* const* us, const void* const* vs,
                               int rank, void* out, int64_t T, int64_t d,
                               int64_t R, void* stream) {
  if (rank < 1 || rank > kMaxRank || d > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0 || R <= 0) return 0;
  Factors f = {};
  bool vec = d % 4 == 0 && aligned16(out);
  for (int k = 0; k < rank; ++k) {
    f.u[k] = static_cast<const float*>(us[k]);
    f.v[k] = static_cast<const float*>(vs[k]);
    vec = vec && aligned16(f.u[k]) && aligned16(f.v[k]);
  }
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* o = static_cast<const int64_t*>(offsets);
  auto* dst = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  cudaError_t err;
  switch (rank) {
    case 1: err = launch<1>(p, o, f, dst, T, di, R, vec, s); break;
    case 2: err = launch<2>(p, o, f, dst, T, di, R, vec, s); break;
    case 3: err = launch<3>(p, o, f, dst, T, di, R, vec, s); break;
    default: err = launch<4>(p, o, f, dst, T, di, R, vec, s); break;
  }
  return static_cast<int>(err);
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
