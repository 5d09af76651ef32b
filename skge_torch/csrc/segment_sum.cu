// Segment sum: out[r, :] += grads[t, :] for every t with idx[t] == r.
//
// Replaces the TPU kernel `segment_sum_pallas` in
// skge_tpu/ops/pallas_segment.py (body `_kernel`). It is the gradient
// scatter of every training step under aggregate="dense_pallas": the
// per-occurrence gradient rows, with the occurrence count fused as a last
// column, are summed into the (R, D) table of the stacked parameters.
//
// Contract (the same as the TPU kernel): ids < 0 or >= R are dropped, and
// negative ids do not wrap. fp32 only. The caller zero-fills `out` for the
// atomic paths; the deterministic variant writes every row itself.
//
// Design. The TPU kernel keeps the whole table in VMEM and runs a
// sequential read-modify-write loop, because the TPU has no fast scatter.
// Hopper has fp32 atomics in L2, so here each thread takes one piece of
// one gradient row and adds it into the table with one atomic reduction.
// Two paths:
// - 16-byte (D % 4 == 0, grads and out 16-byte aligned; the wrapper
//   decides): a piece is a float4, one 16-byte load and one 16-byte
//   reduction (Hopper's float4 atomicAdd), a quarter of the atomic
//   operations of a float at a time. The (occurrence, piece) space is
//   flattened, so a warp covers neighbouring pieces of one or two rows and
//   no lane idles on a ragged last column tile.
// - scalar (any other D, e.g. the D = 1 count scatter): a piece is one
//   float; columns run along threadIdx.x (a warp reads 32 neighbouring
//   floats of one row), occurrences along threadIdx.y and blockIdx.y,
//   column tiles along blockIdx.x.
//
// Bound. T*D*4 bytes in (the gradient rows, 55 MB at the iid TransE
// step's T = 91,808, D = 152) and R*D*4 bytes out: reading the input
// bounds it. Atomics land in no fixed order, so the fp32 summation order,
// and so the last bits of the result, vary from run to run.
//
// Deterministic variant (skge_segment_sum_rows_f32, then
// skge_segment_sum_combine_f32). It sums each row's occurrences in their
// order, as the TPU kernel's loop does, with no atomics: the same bits on
// every run. The caller groups the occurrences by row first
// (group_by_row.cu): `perm` lists the positions row by row, each row's in
// order, `offsets` (R + 1) the start of each row's run and `keys` the
// sorted ids, all int32.
// - Row-major: a team of lanes owns one output row, each lane a float4 (or
//   a float) piece of it, and walks the row's run in perm. A team is
//   G = the next power of two of the row's pieces, up to a warp (rows of
//   fewer than 32 pieces, down to the D = 1 count scatter, share a warp);
//   rows of 32 to 1,023 pieces take a warp, which steps over the pieces;
//   wider rows (D >= 4,096, the class that segment_mean_dense scatters
//   apart) take a block of 256 threads. All lanes of a team load the same
//   perm[j]: one request, broadcast. A lane issues the loads of kAhead
//   occurrences before it adds the first, then adds them in order.
// - Each row is written once, zeros where no occurrence lands, so the
//   wrapper allocates `out` with torch.empty: no zero-fill pass. Where
//   there are few teams' worth of warps for the rows' count (505,128 rows
//   at the out-of-core flagship's 1M step), a warp takes several
//   consecutive rows, their offsets read in one load and shuffled out.
// - Hot rows: a run longer than kChunk occurrences is cut into chunks of
//   kChunk from its start. Chunk 0 is summed by the row's team into `out`;
//   chunk k >= 1, which starts at position q = start + k*kChunk, by a team
//   of its own into scratch row q / kChunk (one chunk at most starts in any
//   kChunk positions: a run that reaches past one chunk start covers the
//   kChunk positions before the next). The combine launch then adds, for
//   each long row, chunks 1, 2, ... to chunk 0 in chunk order. Every sum
//   has a fixed order: a row of <= kChunk occurrences is summed
//   sequentially, bit for bit the sum of a plain loop; a longer row is the
//   in-order sum of its chunks' in-order sums, which
//   cuda_segment.segment_sum_ordered_reference repeats op for op.
// kChunk = 128: a row of all T = 10,688 occurrences becomes 84 chunks of
// 16 rounds of kAhead loads, and a combine of 11 rounds; 64 would double
// the combine's rounds, 256 the chunks'.
// Bound: the same as the atomic path's (T*D*4 bytes in, R*D*4 out). With
// no zero-fill the table is written once, so where R*D dominates (a 1M
// entity bucket's 137 MB) the write alone bounds it.
//
// Offsets are 64-bit: T*D reaches ~2e9 for wide (d*d) rows.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // 16-byte path: threads a block
constexpr int64_t kMaxBlocks = 1 << 20;  // a grid-stride loop covers the rest
constexpr int kCols = 32;                // scalar path: threadIdx.x, a column tile
constexpr int kRows = 8;                 // threadIdx.y: occurrences a block a pass
constexpr int64_t kMaxGridY = 65535;

// q, r = divmod(a, b) for a >= 0, b > 0: in 32 bits where both fit, a
// fraction of the instructions of a 64-bit division.
__device__ __forceinline__ void divmod(int64_t a, int64_t b, int64_t& q,
                                       int64_t& r) {
  if (((a | b) >> 31) == 0) {
    q = static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  } else {
    q = a / b;
  }
  r = a - q * b;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_f32x4_kernel(const int64_t* __restrict__ idx,
                             const float4* __restrict__ grads,
                             float4* __restrict__ out, const int64_t T,
                             const int64_t pieces, const int64_t R) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // (t, c) = divmod(piece, pieces), stepped by divmod(stride, pieces)
  int64_t t, c, dt, dc;
  divmod(first, pieces, t, c);
  divmod(stride, pieces, dt, dc);
  while (t < T) {
    const int64_t r = idx[t];
    if (r >= 0 && r < R) atomicAdd(out + r * pieces + c, __ldg(grads + t * pieces + c));
    t += dt;
    c += dc;
    if (c >= pieces) {
      c -= pieces;
      ++t;
    }
  }
}

__global__ void segment_sum_f32_kernel(const int64_t* __restrict__ idx,
                                       const float* __restrict__ grads,
                                       float* __restrict__ out, const int64_t T,
                                       const int64_t D, const int64_t R) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kCols + threadIdx.x;
  if (c >= D) return;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kRows;
  for (int64_t t = static_cast<int64_t>(blockIdx.y) * kRows + threadIdx.y;
       t < T; t += stride) {
    const int64_t r = idx[t];
    if (r < 0 || r >= R) continue;
    atomicAdd(out + r * D + c, grads[t * D + c]);
  }
}

__device__ __forceinline__ void accumulate(float& acc, float x) { acc += x; }
__device__ __forceinline__ void accumulate(float4& acc, float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

constexpr int kChunk = 128;      // occurrences a team sums in order
constexpr int kAhead = 8;        // loads in flight a lane
constexpr int kTeamBlock = 256;  // threads a block; the widest team
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// dst[c] = the in-order sum of the rows perm[a:b] of grads, piece c, for the
// pieces c = tl, tl + G, ... of this lane.
template <typename V>
__device__ __forceinline__ void sum_run(const int32_t* __restrict__ perm,
                                        const V* __restrict__ grads, const int64_t pieces,
                                        const int64_t a, const int64_t b,
                                        V* __restrict__ dst, const int tl, const int G) {
  for (int64_t c = tl; c < pieces; c += G) {
    V acc = {};
    for (int64_t j = a; j < b; j += kAhead) {
      int32_t p[kAhead];
      V x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) p[u] = j + u < b ? __ldg(perm + j + u) : 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j + u < b) x[u] = __ldg(grads + static_cast<int64_t>(p[u]) * pieces + c);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j + u < b) accumulate(acc, x[u]);
      }
    }
    dst[c] = acc;
  }
}

// This thread's team (G lanes, or the block where G == kTeamBlock) and its
// lane in it.
__device__ __forceinline__ int64_t team_of(const int G, int& tl) {
  tl = static_cast<int>(threadIdx.x) & (G - 1);
  return static_cast<int64_t>(blockIdx.x) * (kTeamBlock / G) + threadIdx.x / G;
}

// Teams [0, row_teams): rows [team*rpt, team*rpt + rpt), the first kChunk
// occurrences of each, into out. Teams [row_teams, teams): the position
// block p = team - row_teams, the chunk of a long row that starts in it,
// into scratch row p.
template <typename V>
__global__ void __launch_bounds__(kTeamBlock)
    segment_sum_rows_kernel(const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ offsets,
                            const V* __restrict__ grads, V* __restrict__ out,
                            V* __restrict__ scratch, const int64_t pieces,
                            const int64_t R, const int G, const int rpt,
                            const int64_t row_teams, const int64_t teams) {
  int tl;
  const int64_t team = team_of(G, tl);
  if (team < row_teams) {
    const int64_t r0 = team * rpt;
    if (rpt == 1) {
      if (r0 >= R) return;
      const int64_t a = offsets[r0], e = offsets[r0 + 1];
      sum_run(perm, grads, pieces, a, lmin(e, a + kChunk), out + r0 * pieces, tl, G);
      return;
    }
    // G == 32: lane i holds offsets[r0 + i], i <= rpt < 32
    const int32_t o = offsets[lmin(r0 + tl, R)];
    for (int i = 0; i < rpt; ++i) {
      const int64_t a = __shfl_sync(kFull, o, i), e = __shfl_sync(kFull, o, i + 1);
      if (r0 + i < R) {
        sum_run(perm, grads, pieces, a, lmin(e, a + kChunk), out + (r0 + i) * pieces, tl, G);
      }
    }
    return;
  }
  if (team >= teams) return;
  const int64_t p = team - row_teams, q0 = p * kChunk;
  const int32_t r = keys[q0];  // the only row that can have a chunk start in block p
  if (r < 0 || r >= R) return;
  const int64_t s = offsets[r], e = offsets[r + 1];
  if (s == q0) return;  // its chunk 0, the row team's
  const int64_t q = s + (q0 - s + kChunk - 1) / kChunk * kChunk;
  if (q >= e) return;
  sum_run(perm, grads, pieces, q, lmin(e, q + kChunk), scratch + p * pieces, tl, G);
}

// Team p: the long row that starts in position block p, if any (the row at
// the block's last position); out[r] = chunk 0 + chunk 1 + ..., in order.
template <typename V>
__global__ void __launch_bounds__(kTeamBlock)
    segment_sum_combine_kernel(const int32_t* __restrict__ keys,
                               const int32_t* __restrict__ offsets,
                               V* __restrict__ out, const V* __restrict__ scratch,
                               const int64_t T, const int64_t pieces, const int64_t R,
                               const int G, const int64_t teams) {
  int tl;
  const int64_t p = team_of(G, tl);
  if (p >= teams) return;
  const int64_t q0 = p * kChunk;
  const int32_t r = keys[lmin(q0 + kChunk, T) - 1];
  if (r < 0 || r >= R) return;
  const int64_t s = offsets[r], e = offsets[r + 1];
  if (s < q0 || e - s <= kChunk) return;
  const int64_t chunks = (e - s + kChunk - 1) / kChunk;  // chunk k in scratch row p + k
  for (int64_t c = tl; c < pieces; c += G) {
    V acc = out[r * pieces + c];
    for (int64_t k = 1; k < chunks; k += kAhead) {
      V x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (k + u < chunks) x[u] = scratch[(p + k + u) * pieces + c];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (k + u < chunks) accumulate(acc, x[u]);
      }
    }
    out[r * pieces + c] = acc;
  }
}

// G, the team: the pieces' next power of two up to a warp; a warp up to
// 1,023 pieces; a block beyond.
int team_size(int64_t pieces) {
  if (pieces >= 1024) return kTeamBlock;
  if (pieces > 32) return 32;
  int g = 1;
  while (g < pieces) g <<= 1;
  return g;
}

bool bad_vector(int vector, int64_t D, const void* a, const void* b) {
  return vector && (D % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(b) % 16 != 0);
}

}  // namespace

extern "C" {

// vector != 0: the 16-byte path; D % 4 == 0 and grads, out 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() (0 when launched).
int skge_segment_sum_f32(const void* idx, const void* grads, void* out,
                         int64_t T, int64_t D, int64_t R, int vector,
                         void* stream) {
  if (vector && (D % 4 != 0 || reinterpret_cast<uintptr_t>(grads) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T <= 0 || D <= 0 || R <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int64_t*>(idx);
  if (vector) {
    int64_t blocks = (T * (D / 4) + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    segment_sum_f32x4_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        i, static_cast<const float4*>(grads), static_cast<float4*>(out), T,
        D / 4, R);
  } else {
    const int64_t gx = (D + kCols - 1) / kCols;
    if (gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    int64_t gy = (T + kRows - 1) / kRows;
    if (gy > kMaxGridY) gy = kMaxGridY;
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    segment_sum_f32_kernel<<<grid, dim3(kCols, kRows), 0, s>>>(
        i, static_cast<const float*>(grads), static_cast<float*>(out), T, D, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deterministic variant's first launch. keys, perm (T,) and offsets
// (R + 1,): int32, group_by_row.cu's output for these ids and R. scratch:
// (ceil(T / kChunk), D) floats, 16-byte aligned where vector != 0 (only
// where T > kChunk: nothing else reads or writes it). Every row of `out` is
// written. Launches on `stream`; returns cudaGetLastError() (0 when
// launched).
int skge_segment_sum_rows_f32(const void* keys, const void* perm, const void* offsets,
                              const void* grads, void* out, void* scratch, int64_t T,
                              int64_t D, int64_t R, int vector, void* stream) {
  if (bad_vector(vector, D, grads, out) ||
      (vector && T > kChunk && reinterpret_cast<uintptr_t>(scratch) % 16 != 0) ||
      T >= 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T <= 0 || D <= 0 || R <= 0) return 0;
  const int64_t pieces = vector ? D / 4 : D;
  const int G = team_size(pieces);
  // a warp takes several rows where one each would give more than two
  // full waves of warps
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t waves = 2 * static_cast<int64_t>(sms) * 64;
  const int rpt = G == 32 ? static_cast<int>(std::min<int64_t>(31, std::max<int64_t>(1, R / waves))) : 1;
  const int64_t row_teams = (R + rpt - 1) / rpt;
  const int64_t teams = row_teams + (T > kChunk ? (T + kChunk - 1) / kChunk : 0);
  const int64_t per_block = kTeamBlock / G;
  const int64_t blocks = (teams + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* o = static_cast<const int32_t*>(offsets);
  if (vector) {
    segment_sum_rows_kernel<float4><<<static_cast<unsigned>(blocks), kTeamBlock, 0, s>>>(
        k, p, o, static_cast<const float4*>(grads), static_cast<float4*>(out),
        static_cast<float4*>(scratch), pieces, R, G, rpt, row_teams, teams);
  } else {
    segment_sum_rows_kernel<float><<<static_cast<unsigned>(blocks), kTeamBlock, 0, s>>>(
        k, p, o, static_cast<const float*>(grads), static_cast<float*>(out),
        static_cast<float*>(scratch), pieces, R, G, rpt, row_teams, teams);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deterministic variant's second launch, needed only where T > kChunk
// (a longer run cannot exist otherwise): adds each long row's chunks, in
// order, to its chunk 0 in `out`. Same arguments as the first launch.
int skge_segment_sum_combine_f32(const void* keys, const void* offsets, void* out,
                                 const void* scratch, int64_t T, int64_t D, int64_t R,
                                 int vector, void* stream) {
  if (bad_vector(vector, D, scratch, out) || T >= 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T <= kChunk || D <= 0 || R <= 0) return 0;
  const int64_t pieces = vector ? D / 4 : D;
  const int G = team_size(pieces);
  const int64_t teams = (T + kChunk - 1) / kChunk;
  const int64_t per_block = kTeamBlock / G;
  const int64_t blocks = (teams + per_block - 1) / per_block;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* o = static_cast<const int32_t*>(offsets);
  if (vector) {
    segment_sum_combine_kernel<float4><<<static_cast<unsigned>(blocks), kTeamBlock, 0, s>>>(
        k, o, static_cast<float4*>(out), static_cast<const float4*>(scratch), T, pieces, R,
        G, teams);
  } else {
    segment_sum_combine_kernel<float><<<static_cast<unsigned>(blocks), kTeamBlock, 0, s>>>(
        k, o, static_cast<float*>(out), static_cast<const float*>(scratch), T, pieces, R,
        G, teams);
  }
  return static_cast<int>(cudaGetLastError());
}

// kChunk, for the wrapper's plain version of the same order.
int64_t skge_segment_sum_chunk() { return kChunk; }

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
