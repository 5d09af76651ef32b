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
// Hopper has hardware fp32 atomics in L2, so this kernel is one thread per
// (occurrence, column): columns run along threadIdx.x (a warp reads 32
// neighbouring floats of one gradient row, coalesced), occurrences along
// threadIdx.y and blockIdx.y (a grid-stride loop covers any T), column
// tiles along blockIdx.x. Each element is one atomicAdd into the table.
//
// Bound. It moves T*D floats in and does T*D atomic adds; it is bound by
// atomic traffic to L2 and by device-memory bytes, not by arithmetic.
// Because atomics land in no fixed order, the fp32 summation order, and so
// the last bits of the result, vary from run to run. A deterministic
// sort-plus-segmented-reduce variant is later work.
//
// Offsets are 64-bit: T*D reaches ~2e9 for wide (d*d) rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;  // threadIdx.x: one warp across a column tile
constexpr int kRows = 8;   // threadIdx.y: occurrences per block per pass
constexpr int64_t kMaxGridY = 65535;

__global__ void segment_sum_f32_kernel(const int64_t* __restrict__ idx,
                                       const float* __restrict__ grads,
                                       float* __restrict__ out, int64_t T,
                                       int64_t D, int64_t R) {
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

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 when launched).
int skge_segment_sum_f32(const void* idx, const void* grads, void* out,
                         int64_t T, int64_t D, int64_t R, void* stream) {
  if (T <= 0 || D <= 0 || R <= 0) return 0;
  const int64_t gx = (D + kCols - 1) / kCols;
  if (gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int64_t gy = (T + kRows - 1) / kRows;
  if (gy > kMaxGridY) gy = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const dim3 block(kCols, kRows);
  segment_sum_f32_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), static_cast<const float*>(grads),
      static_cast<float*>(out), T, D, R);
  return static_cast<int>(cudaGetLastError());
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
