// Segment outer sum: out[r] += sum_f u_f[t] (x) v_f[t] for every t with
// idx[t] == r, into an (R, d, d) table.
//
// Replaces the TPU kernel `segment_outer_sum_pallas` in
// skge_tpu/ops/pallas_outer.py (body `_kernel`). It is RESCAL's W-gradient
// scatter under the dense aggregate modes: each positive's W gradient is the
// rank-2 sum es (x) dq + dr (x) eo, handed over as its (T, d) factors, so the
// (T, d, d) outer products never exist in device memory.
//
// Contract (the same as the TPU kernel): all rank terms of one occurrence
// are summed before the table add; ids < 0 or >= R are dropped, and negative
// ids do not wrap. fp32 only, rank <= kMaxRank. The caller zero-fills `out`.
//
// Design. The TPU kernel keeps the table in VMEM and walks the occurrences
// in order with one read-modify-write of a (d, lanes) block each, because
// the TPU has no fast scatter. Hopper has fp32 atomics in L2, so here one
// block takes one occurrence at a time (a grid-stride loop covers any T):
// it stages the 2*rank factor rows in shared memory, then its threads walk
// the d*d cells of the destination row with consecutive threads on
// consecutive cells (j along threadIdx.x, so the stores coalesce), form
// sum_f u_f[i]*v_f[j] in a register and issue ONE atomicAdd per cell.
// Products and sums are rounded as the plain version rounds them
// (__fmul_rn/__fadd_rn: no fused multiply-add), so only the order of the
// atomic adds differs from it.
//
// Bound. It reads 2*rank*T*d floats and issues T*d*d atomic adds: bound by
// atomic throughput in L2, and by contention when few rows take many
// occurrences (WN18's 18 relations). Atomics land in no fixed order, so the
// last bits vary from run to run. A tensor-core variant (sort by row, then
// one segmented W_r += U_r^T V_r) is later work.
//
// Offsets are 64-bit: r*d*d reaches past 2^31 for wide tables.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRank = 4;
constexpr int kMaxThreads = 256;
constexpr int64_t kMaxGrid = 1 << 16;
constexpr int64_t kMaxSharedBytes = 48 * 1024;  // no opt-in attribute needed

struct Factors {
  const float* u[kMaxRank];
  const float* v[kMaxRank];
};

__global__ void segment_outer_sum_f32_kernel(const int64_t* __restrict__ idx,
                                             const Factors f, const int rank,
                                             float* __restrict__ out,
                                             const int64_t T, const int d,
                                             const int64_t R) {
  extern __shared__ float smem[];  // u rows [rank][d], then v rows [rank][d]
  float* su = smem;
  float* sv = smem + rank * d;
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int n = rank * d;
  // the cell walk's stride, as (rows, columns)
  const int di = blockDim.x / d;
  const int dj = blockDim.x - di * d;
  for (int64_t t = blockIdx.x; t < T; t += gridDim.x) {
    const int64_t r = idx[t];
    if (r < 0 || r >= R) continue;  // the same for every thread of the block
    __syncthreads();                // the previous occurrence is done with smem
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int fi = k / d;
      const int64_t src = t * d + (k - fi * d);
      su[k] = f.u[fi][src];
      sv[k] = f.v[fi][src];
    }
    __syncthreads();
    float* row = out + r * dd;
    int i = threadIdx.x / d;
    int j = threadIdx.x - i * d;
    for (int64_t c = threadIdx.x; c < dd; c += blockDim.x) {
      float acc = __fmul_rn(su[i], sv[j]);
      for (int fi = 1; fi < rank; ++fi) {
        acc = __fadd_rn(acc, __fmul_rn(su[fi * d + i], sv[fi * d + j]));
      }
      atomicAdd(row + c, acc);
      i += di;
      j += dj;
      if (j >= d) {
        j -= d;
        ++i;
      }
    }
  }
}

}  // namespace

extern "C" {

// us, vs: host arrays of `rank` device pointers to (T, d) fp32 factors.
// Launches on `stream`; returns cudaGetLastError() (0 when launched).
int skge_segment_outer_sum_f32(const void* idx, const void* const* us,
                               const void* const* vs, int rank, void* out,
                               int64_t T, int64_t d, int64_t R,
                               void* stream) {
  if (rank < 1 || rank > kMaxRank) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = 2 * rank * d * static_cast<int64_t>(sizeof(float));
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || d <= 0 || R <= 0) return 0;
  Factors f = {};
  for (int k = 0; k < rank; ++k) {
    f.u[k] = static_cast<const float*>(us[k]);
    f.v[k] = static_cast<const float*>(vs[k]);
  }
  const int64_t dd = d * d;
  const int threads = static_cast<int>(
      dd >= kMaxThreads ? kMaxThreads : (dd + 31) / 32 * 32);
  const unsigned grid = static_cast<unsigned>(T < kMaxGrid ? T : kMaxGrid);
  segment_outer_sum_f32_kernel<<<grid, threads, static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), f, rank, static_cast<float*>(out), T,
      static_cast<int>(d), R);
  return static_cast<int>(cudaGetLastError());
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
