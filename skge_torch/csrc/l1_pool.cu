// K3: the L1 pool distance and its gradient.
//
//   S[i, j]  = -sum_d |x[i, d] - y[j, d]|                (forward)
//   dq[i, d] = -sum_j G[i, j] s(q[i, d] - p[j, d])         (backward, over j)
//   dp[j, d] = +sum_i G[i, j] s(q[i, d] - p[j, d])         (backward, over i)
//
// with s(t) = +1 where t >= 0 (+0 and -0 included) and -1 otherwise, the
// gradient convention of skge_torch/models/transe.py's `_abs`. The sign is
// decided by comparing q >= p (fp32 subtraction with subnormals is zero
// only for equal operands and keeps the exact difference's sign, so the
// comparison is the plain version's `q - p >= 0`), never by a sign bit.
//
// Replaces no TPU kernel: the JAX package leaves this sweep to XLA. It was
// added because the plain PyTorch sweep (a (B, chunk, d) broadcast, then
// `where`, negation and a sum, recomputed under torch.utils.checkpoint)
// made 99.6% of the TransE-L1 shared-pool step on the H100 (PERF.md §5):
// some 33 passes over device memory a step for ~1e10 fp32 operations.
//
// Bound: fp32 instructions. A (i, j, d) element costs 2 in the forward
// (a subtract, an add with the |.| operand modifier) and 3 in each
// backward reduction (compare, select +-G, add); its inputs are a few MB
// and its output one float per (i, j), so memory is far below the line.
// The design therefore keeps every (i, j, d) term in registers:
// - forward: GEMM-shaped. A block of 256 threads owns a 64 x 64 tile of S,
//   a thread a 4 x 4 register tile. x and y tiles are staged through
//   shared memory 8 d at a time, transposed so that a thread reads its 4
//   rows or columns as one 16-byte load (a quarter-warp reads 128
//   contiguous bytes: no bank conflict); the next chunk's global loads
//   are issued before the current chunk is computed. d is padded with
//   zeros in shared memory, which add exactly 0. Each output sums a
//   chunk's 8 terms in order, then adds the chunk sums with Kahan's
//   compensation (4 more operations a chunk, +25%): a plain running sum of
//   150 terms of ~0.1 drifts ~20 ulps from the exact sum at the worst of a
//   serving batch's 15M scores (1.7e-5 at scores of ~16 on the H100,
//   against the CPU's 4e-6), this stays within ~2e-6. One store per
//   output, 16 bytes wide where J % 4 == 0.
// - backward: one kernel for both reductions. A block owns 64 output rows
//   (8 a warp) and 32 * TD columns of d (a lane TD of them, TD = 1..5 from
//   d), keeps its rows of the output's own side (q for dq, p for dp) and
//   the sums in registers, and streams the other side's rows and G through
//   shared memory 32 at a time. Where the output has too few rows to fill
//   the card (dp: K = 1,024 rows against B = 9,664), the reduction is split
//   into `nsplit` ranges, each block writes its partial sums to a scratch
//   buffer, and a second launch adds the partials in split order. No
//   atomics: every sum has a fixed order, so a result repeats bit for bit.
//
// Sum order: every output sums its terms in the same order (d = 0, 1, ...
// and the chunks in order for the forward; j in order within a split, then the
// splits in order, for the backward), so two equal rows of y give
// bit-equal scores against every x.
//
// Offsets are 64-bit: I * J reaches 1e10 for all-entity sweeps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;          // shared rows padded by 16 bytes: no store conflict
constexpr int kFwdTile = 64;     // forward: rows of x and of y a block (16 threads x 4)
constexpr int kFwdDepth = 8;     // forward: d a chunk in shared memory
constexpr int kGradWarpRows = 8; // backward: output rows a warp
constexpr int kGradRows = kGradWarpRows * (kThreads / 32);  // 64 a block
constexpr int kGradDepth = 32;   // backward: reduced rows a chunk in shared memory
constexpr int kMaxTd = 5;        // backward: d a lane, so 160 a block
constexpr int64_t kMaxGridY = 65535;

// A thread's 4 x 4 outputs: rows ty * 4 + u, columns tx * 4 + v (u, v < 4).
__global__ void __launch_bounds__(kThreads, 2)
    l1_pool_forward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           float* __restrict__ s, const int64_t I, const int64_t J,
                           const int D) {
  constexpr int kLoads = kFwdTile * kFwdDepth / kThreads;  // of x and of y a chunk
  __shared__ __align__(16) float xs[kFwdDepth][kFwdTile + kPad];
  __shared__ __align__(16) float ys[kFwdDepth][kFwdTile + kPad];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kFwdTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kFwdTile;
  float xr[kLoads], yr[kLoads];

  // element e = tid + r * kThreads of a chunk: row e / kFwdDepth, d e % kFwdDepth
  auto load = [&](int d0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kThreads, row = e / kFwdDepth, d = d0 + e % kFwdDepth;
      xr[r] = (i0 + row < I && d < D) ? __ldg(x + (i0 + row) * D + d) : 0.f;
      yr[r] = (j0 + row < J && d < D) ? __ldg(y + (j0 + row) * D + d) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kThreads;
      xs[e % kFwdDepth][e / kFwdDepth] = xr[r];
      ys[e % kFwdDepth][e / kFwdDepth] = yr[r];
    }
  };

  // sum = the chunks' partial sums added with Kahan's compensation `comp`
  float sum[4][4], comp[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) sum[u][v] = comp[u][v] = 0.f;
  }
  const int chunks = (D + kFwdDepth - 1) / kFwdDepth;
  load(0);
  stash();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load((c + 1) * kFwdDepth);  // in flight during the chunk
    float part[4][4] = {};
#pragma unroll
    for (int dd = 0; dd < kFwdDepth; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[dd][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[dd][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) part[u][v] += fabsf(av[u] - bv[v]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float t = part[u][v] - comp[u][v], next = sum[u][v] + t;
        comp[u][v] = (next - sum[u][v]) - t;
        sum[u][v] = next;
      }
    }
    if (c + 1 < chunks) {
      __syncthreads();  // every thread is done with this chunk
      stash();
      __syncthreads();
    }
  }

  const int64_t col = j0 + tx * 4;
  const bool vec = J % 4 == 0;  // rows start 16-byte aligned (the base is)
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t row = i0 + ty * 4 + u;
    if (row >= I) continue;
    float o[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = comp[u][v] - sum[u][v];  // -(sum - comp)
    float* out = s + row * J;
    if (vec) {
      if (col < J) *reinterpret_cast<float4*>(out + col) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (col + v < J) out[col + v] = o[v];
      }
    }
  }
}

// One partial sum of the backward, for the rows i of x (the output's side)
// against the rows j in [z * jper, (z + 1) * jper) of y:
//   dq (kDp false, x = q, y = p, g (I, J)): sum_j (x >= y ? -g[i, j] : g[i, j])
//   dp (kDp true,  x = p, y = q, g (J, I)): sum_j (x <= y ? g[j, i] : -g[j, i])
// written to out[z] (I, D). Lane l holds d = d0 + l + 32 t, t < TD.
template <int TD, bool kDp>
__global__ void __launch_bounds__(kThreads, 2)
    l1_pool_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ g, float* __restrict__ out,
                        const int64_t I, const int64_t J, const int D, const int64_t jper) {
  constexpr int BD = 32 * TD;
  constexpr int TM = kGradWarpRows;
  __shared__ __align__(16) float ys[kGradDepth][BD];
  __shared__ __align__(16) float ws[kGradDepth][kGradRows + kPad];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kGradRows;
  const int d0 = blockIdx.y * BD;
  const int64_t jb = static_cast<int64_t>(blockIdx.z) * jper;
  const int64_t je = jb + jper < J ? jb + jper : J;

  float xr[TM][TD], acc[TM][TD];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t row = i0 + warp * TM + m;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int d = d0 + lane + 32 * t;
      xr[m][t] = (row < I && d < D) ? __ldg(x + row * D + d) : 0.f;
      acc[m][t] = 0.f;
    }
  }

  for (int64_t c0 = jb; c0 < je; c0 += kGradDepth) {
    const int n = je - c0 < kGradDepth ? static_cast<int>(je - c0) : kGradDepth;
    __syncthreads();  // the previous chunk is read
    for (int e = threadIdx.x; e < kGradDepth * BD; e += kThreads) {
      const int jj = e / BD, d = d0 + e % BD;
      ys[jj][e % BD] = (jj < n && d < D) ? __ldg(y + (c0 + jj) * D + d) : 0.f;
    }
    for (int e = threadIdx.x; e < kGradDepth * kGradRows; e += kThreads) {
      // along g's contiguous axis: i for dp's g (J, I), j for dq's g (I, J)
      const int jj = kDp ? e / kGradRows : e % kGradDepth;
      const int mm = kDp ? e % kGradRows : e / kGradDepth;
      const int64_t i = i0 + mm, j = c0 + jj;
      float w = 0.f;
      if (jj < n && i < I) w = __ldg(kDp ? g + j * I + i : g + i * J + j);
      ws[jj][mm] = w;
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      float yv[TD], pos[TM], neg[TM];
#pragma unroll
      for (int t = 0; t < TD; ++t) yv[t] = ys[jj][lane + 32 * t];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[jj][warp * TM + 4 * h]);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pos[4 * h + u] = kDp ? w[u] : -w[u];  // the term where the comparison holds
          neg[4 * h + u] = -pos[4 * h + u];
        }
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int t = 0; t < TD; ++t) {
          const bool hit = kDp ? xr[m][t] <= yv[t] : xr[m][t] >= yv[t];
          acc[m][t] += hit ? pos[m] : neg[m];
        }
      }
    }
  }

  float* o = out + static_cast<int64_t>(blockIdx.z) * I * D;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t row = i0 + warp * TM + m;
    if (row >= I) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int d = d0 + lane + 32 * t;
      if (d < D) o[row * D + d] = acc[m][t];
    }
  }
}

// out[e] = partials[0][e] + partials[1][e] + ... in split order.
__global__ void __launch_bounds__(kThreads)
    l1_pool_combine_kernel(const float* __restrict__ partials, float* __restrict__ out,
                           const int64_t n, const int nsplit) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    float a = partials[e];
    for (int z = 1; z < nsplit; ++z) a += partials[z * n + e];
    out[e] = a;
  }
}

template <int TD>
void launch_grad(const float* x, const float* y, const float* g, float* out, int64_t I,
                 int64_t J, int D, int64_t jper, int dp, const dim3& grid, cudaStream_t s) {
  if (dp) {
    l1_pool_grad_kernel<TD, true><<<grid, kThreads, 0, s>>>(x, y, g, out, I, J, D, jper);
  } else {
    l1_pool_grad_kernel<TD, false><<<grid, kThreads, 0, s>>>(x, y, g, out, I, J, D, jper);
  }
}

}  // namespace

extern "C" {

// S (I, J) = -sum_d |x[i] - y[j]| for x (I, D), y (J, D), all fp32,
// contiguous. Launches on `stream`; returns cudaGetLastError() (0 when
// launched).
int skge_l1_pool_forward_f32(const void* x, const void* y, void* s, int64_t I, int64_t J,
                             int64_t D, void* stream) {
  if (D >= 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (I <= 0 || J <= 0) return 0;
  const int64_t gx = (J + kFwdTile - 1) / kFwdTile, gy = (I + kFwdTile - 1) / kFwdTile;
  if (gx > 0x7fffffff || gy > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  l1_pool_forward_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(s), I,
      J, static_cast<int>(D));
  return static_cast<int>(cudaGetLastError());
}

// One gradient of S: dq (dp == 0: x = q (I, D), y = p (J, D), g (I, J)) or
// dp (dp != 0: x = p (I, D), y = q (J, D), g (J, I)), into out (I, D). `td`
// (1..5) d a lane; `nsplit` ranges of the reduced rows, whose partial sums
// go to `scratch` (nsplit, I, D) and are then added in order into `out` by
// a second launch (scratch unused where nsplit == 1). All fp32, contiguous.
int skge_l1_pool_grad_f32(const void* x, const void* y, const void* g, void* out,
                          void* scratch, int64_t I, int64_t J, int64_t D, int td, int dp,
                          int nsplit, void* stream) {
  if (td < 1 || td > kMaxTd || nsplit < 1 || nsplit > 65535 || D >= 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (I <= 0 || D <= 0) return 0;
  const int64_t gx = (I + kGradRows - 1) / kGradRows, gy = (D + 32 * td - 1) / (32 * td);
  if (gx > 0x7fffffff || gy > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(nsplit));
  const int64_t jper = (J + nsplit - 1) / nsplit;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  const auto* gp = static_cast<const float*>(g);
  float* dst = static_cast<float*>(nsplit > 1 ? scratch : out);
  const int d = static_cast<int>(D);
  switch (td) {
    case 1: launch_grad<1>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st); break;
    case 2: launch_grad<2>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st); break;
    case 3: launch_grad<3>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st); break;
    case 4: launch_grad<4>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st); break;
    default: launch_grad<5>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st); break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int64_t n = I * D;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;  // a grid-stride loop covers the rest
  l1_pool_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      dst, static_cast<float*>(out), n, nsplit);
  return static_cast<int>(cudaGetLastError());
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
