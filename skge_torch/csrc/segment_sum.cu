// Segment sum: out[r, :] += grads[t, :] for every t with idx[t] == r.
//
// Replaces the TPU kernel `segment_sum_pallas` in
// skge_tpu/ops/pallas_segment.py (body `_kernel`). It is the gradient
// scatter of every training step under aggregate="dense_pallas": the
// per-occurrence gradient rows, with the occurrence count fused as a last
// column, are summed into the (R, D) table of the stacked parameters.
//
// Contract (the same as the TPU kernel): ids < 0 or >= R are dropped, and
// negative ids do not wrap. fp32 only. The caller zero-fills `out`.
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
// Deterministic variant (skge_segment_sum_sorted_f32). The caller passes
// the ids sorted by a stable sort and the permutation that sorts them.
// The thread of (sorted position i, piece c) that heads a run of equal
// ids sums that run's rows in their original order, starting from 0, and
// stores the sum with a plain write: no atomics, the same bits on every
// run, and the order of a sequential scatter. Other threads return after
// two id loads. A run is summed by one thread, so a hot id serialises;
// this variant is for runs that must repeat bit for bit, not for speed.
//
// Offsets are 64-bit: T*D reaches ~2e9 for wide (d*d) rows.

#include <cuda_runtime.h>

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

template <typename V>
__global__ void __launch_bounds__(kThreads)
    segment_sum_sorted_kernel(const int64_t* __restrict__ sorted,
                              const int64_t* __restrict__ order,
                              const V* __restrict__ grads, V* __restrict__ out,
                              const int64_t T, const int64_t pieces,
                              const int64_t R) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t i, c, di, dc;
  divmod(first, pieces, i, c);
  divmod(stride, pieces, di, dc);
  for (; i < T; i += di, c += dc) {
    if (c >= pieces) {
      c -= pieces;
      ++i;
      if (i >= T) break;
    }
    const int64_t r = sorted[i];
    if (r < 0 || r >= R || (i > 0 && sorted[i - 1] == r)) continue;
    V acc = {};
    for (int64_t j = i; j < T && sorted[j] == r; ++j) {
      accumulate(acc, __ldg(grads + order[j] * pieces + c));
    }
    out[r * pieces + c] = acc;
  }
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

// The deterministic variant: `sorted` holds the T ids in stable-sorted
// order, `order` the permutation that sorts them (sorted[i] ==
// idx[order[i]]). The caller zero-fills `out`. vector != 0 as above.
int skge_segment_sum_sorted_f32(const void* sorted, const void* order,
                                const void* grads, void* out, int64_t T,
                                int64_t D, int64_t R, int vector, void* stream) {
  if (vector && (D % 4 != 0 || reinterpret_cast<uintptr_t>(grads) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T <= 0 || D <= 0 || R <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const int64_t*>(sorted);
  const auto* oi = static_cast<const int64_t*>(order);
  const int64_t pieces = vector ? D / 4 : D;
  int64_t blocks = (T * pieces + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vector) {
    segment_sum_sorted_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        si, oi, static_cast<const float4*>(grads), static_cast<float4*>(out), T,
        pieces, R);
  } else {
    segment_sum_sorted_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        si, oi, static_cast<const float*>(grads), static_cast<float*>(out), T,
        pieces, R);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
