// K6: RotatE's complex-modulus pool distance and its gradient.
//
// Rows are complex vectors of width D in the port's layout, real parts
// first: x[i] = (x[i, 0..D), x[i, D..2D)) = (re, im). With
// dx = x_re[i, c] - y_re[j, c], dy = x_im[i, c] - y_im[j, c] and
// m = sqrt(dx^2 + dy^2), the modulus of one complex difference:
//
//   S[i, j]      = -sum_c m                                   (forward)
//   dq[i, c]     = -sum_j G[i, j] dx / m,  likewise dy for c + D  (over j)
//   dp[j, c]     = +sum_i G[i, j] dx / m,  likewise dy            (over i)
//
// and 0 in place of dx / m and dy / m where m == 0: the gradient that
// torch.linalg.vector_norm gives at 0, and the RotatE authors' code with it.
// Both gradients have one form, out[r] = -sum G (x[r] - y) / m, with x the
// output's side (q for dq, p for dp) and G read transposed for dp.
//
// Replaces no TPU kernel: the JAX package, and the port's default RotatE,
// score the squared distance, one matmul through the norm expansion. The
// published distance (Sun et al. 2019) sums the moduli, which is no matmul:
// plain PyTorch would build a (B, K, 2D) tensor, 4.2 GB a step at FB15k's
// published shape (B = 2 x 1,024 stacked queries, K = 256, D = 1,000), or
// recompute it chunk by chunk.
//
// Bound: the special-function unit. Each (i, j, c) element costs the
// forward two subtracts, a multiply, an FMA, a square root and an add, and
// each gradient the same distance, a reciprocal square root, two multiplies
// and two FMAs. The square roots run on the SM's 16 special-function lanes
// (a warp's in 8 cycles of a sub-core, against 1 for an fp32 instruction),
// so an element costs ~8 issue cycles of 32 lanes in every pass, whatever
// the fp32 count; the inputs are a few MB and the output one float per
// (i, j), far below the memory line. Every (i, j, c) term stays in
// registers:
// - forward: GEMM-shaped, as K3's. A block of 256 threads owns a 64 x 64
//   tile of S, a thread a 4 x 4 register tile; real and imaginary tiles of
//   x and y are staged through shared memory 8 complex dimensions at a time,
//   transposed so that a thread reads its 4 rows as one 16-byte load. Each
//   output sums a chunk's 8 moduli in order and the chunk sums with Kahan's
//   compensation (a plain running sum of 1,000 terms of ~0.02 drifts ~1e-5).
//   Where the tiles alone would leave slots of the card empty (the pool
//   step: 128 tiles), the c axis is split, each split writes its partial
//   S to a scratch buffer, and a second launch adds them in split order.
// - backward: as K3's. A block owns 64 output rows (8 a warp) and 32 * TD
//   complex columns (a lane TD of them, TD = 1 or 2), keeps its rows of
//   the output's side and both sums in registers, and streams the other
//   side's rows and G through shared memory 32 at a time, the reduction
//   split into `nsplit` ranges where the output alone leaves slots empty
//   (dp: 256 pool rows), partial sums combined in split order.
//   1 / m is rsqrt(dx^2 + dy^2 + FLT_MIN), applied to dx and dy before G:
//   at m == 0 both are exactly 0, so the term is exactly 0, and elsewhere
//   the FLT_MIN is below half an ulp of any dx^2 above 1e-31.
// No atomics: every sum has a fixed order, so a result repeats bit for bit
// and two equal rows of y give bit-equal scores against every x.
//
// The square roots are the hardware's approximations (sqrt.approx.ftz.f32,
// rsqrt.approx.ftz.f32, a few ulps), one special-function instruction
// each: a squared modulus below 2^-126 (a modulus below 1.1e-19) counts as
// 0 in the forward; the backward's root takes dx^2 + dy^2 + FLT_MIN, never
// subnormal.
// Offsets are 64-bit: I * J reaches 1.5e7 a serving batch and more for
// all-entity sweeps.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;          // shared rows padded by 16 bytes: no store conflict
constexpr int kFwdTile = 64;     // forward: rows of x and of y a block (16 threads x 4)
constexpr int kFwdDepth = 8;     // forward: complex dimensions a chunk in shared memory
constexpr int kGradWarpRows = 8; // backward: output rows a warp
constexpr int kGradRows = kGradWarpRows * (kThreads / 32);  // 64 a block
constexpr int kGradDepth = 32;   // backward: reduced rows a chunk in shared memory
constexpr int kMaxTd = 2;        // backward: complex dimensions a lane, so 64 a block
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Split z of the forward: the complex dimensions [z * cper, (z + 1) * cper)
// into s + z * I * J. A thread's 4 x 4 outputs: rows ty * 4 + u, columns
// tx * 4 + v.
__global__ void __launch_bounds__(kThreads, 2)
    rotate_pool_forward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               float* __restrict__ s, const int64_t I, const int64_t J,
                               const int D, const int cper) {
  constexpr int kLoads = kFwdTile * kFwdDepth / kThreads;  // of each part a chunk
  __shared__ __align__(16) float xs[2][kFwdDepth][kFwdTile + kPad];  // [re, im][c][row]
  __shared__ __align__(16) float ys[2][kFwdDepth][kFwdTile + kPad];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kFwdTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kFwdTile;
  const int cb = blockIdx.z * cper, ce = cb + cper < D ? cb + cper : D;
  const int64_t W = 2 * static_cast<int64_t>(D);
  float xr[2][kLoads], yr[2][kLoads];

  // element e = tid + r * kThreads of a chunk: row e / kFwdDepth, c e % kFwdDepth
  auto load = [&](int c0) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kThreads, row = e / kFwdDepth, c = c0 + e % kFwdDepth;
      const bool okx = i0 + row < I && c < ce, oky = j0 + row < J && c < ce;
      const float* xp = x + (i0 + row) * W + c;
      const float* yp = y + (j0 + row) * W + c;
      xr[0][r] = okx ? __ldg(xp) : 0.f;
      xr[1][r] = okx ? __ldg(xp + D) : 0.f;
      yr[0][r] = oky ? __ldg(yp) : 0.f;
      yr[1][r] = oky ? __ldg(yp + D) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = tid + r * kThreads;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xs[h][e % kFwdDepth][e / kFwdDepth] = xr[h][r];
        ys[h][e % kFwdDepth][e / kFwdDepth] = yr[h][r];
      }
    }
  };

  // sum = the chunks' partial sums added with Kahan's compensation `comp`
  float sum[4][4], comp[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) sum[u][v] = comp[u][v] = 0.f;
  }
  const int chunks = (ce - cb + kFwdDepth - 1) / kFwdDepth;
  load(cb);
  stash();
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) load(cb + (k + 1) * kFwdDepth);  // in flight during the chunk
    float part[4][4] = {};
#pragma unroll
    for (int dd = 0; dd < kFwdDepth; ++dd) {
      const float4 ar = *reinterpret_cast<const float4*>(&xs[0][dd][ty * 4]);
      const float4 ai = *reinterpret_cast<const float4*>(&xs[1][dd][ty * 4]);
      const float4 br = *reinterpret_cast<const float4*>(&ys[0][dd][tx * 4]);
      const float4 bi = *reinterpret_cast<const float4*>(&ys[1][dd][tx * 4]);
      const float xre[4] = {ar.x, ar.y, ar.z, ar.w}, xim[4] = {ai.x, ai.y, ai.z, ai.w};
      const float yre[4] = {br.x, br.y, br.z, br.w}, yim[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float dx = xre[u] - yre[v], dy = xim[u] - yim[v];
          part[u][v] += sqrt_approx(fmaf(dy, dy, dx * dx));  // padding adds sqrt(0) = 0
        }
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
    if (k + 1 < chunks) {
      __syncthreads();  // every thread is done with this chunk
      stash();
      __syncthreads();
    }
  }

  float* out = s + static_cast<int64_t>(blockIdx.z) * I * J;
  const int64_t col = j0 + tx * 4;
  const bool vec = J % 4 == 0;  // rows start 16-byte aligned (the base is)
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t row = i0 + ty * 4 + u;
    if (row >= I) continue;
    float o[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = comp[u][v] - sum[u][v];  // -(sum - comp)
    float* dst = out + row * J;
    if (vec) {
      if (col < J) *reinterpret_cast<float4*>(dst + col) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (col + v < J) dst[col + v] = o[v];
      }
    }
  }
}

// One partial sum of the backward, for the rows i of x (the output's side)
// against the rows j in [z * jper, (z + 1) * jper) of y:
//   out[z][i] = -sum_j G (x[i] - y[j]) / m, G = g[i, j] (dq: kDp false,
//   g (I, J)) or g[j, i] (dp: kDp true, g (J, I)),
// written to out + z * I * 2D. Lane l holds complex columns
// c = c0 + l + 32 t, t < TD: their real parts and, D further, their
// imaginary parts.
template <int TD, bool kDp>
__global__ void __launch_bounds__(kThreads, 2)
    rotate_pool_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                            const float* __restrict__ g, float* __restrict__ out,
                            const int64_t I, const int64_t J, const int D, const int64_t jper) {
  constexpr int BD = 32 * TD;
  constexpr int TM = kGradWarpRows;
  __shared__ __align__(16) float ys[2][kGradDepth][BD];
  __shared__ __align__(16) float ws[kGradDepth][kGradRows + kPad];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kGradRows;
  const int c0 = blockIdx.y * BD;
  const int64_t jb = static_cast<int64_t>(blockIdx.z) * jper;
  const int64_t je = jb + jper < J ? jb + jper : J;
  const int64_t W = 2 * static_cast<int64_t>(D);

  float xre[TM][TD], xim[TM][TD], are[TM][TD], aim[TM][TD];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t row = i0 + warp * TM + m;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int c = c0 + lane + 32 * t;
      const bool ok = row < I && c < D;
      xre[m][t] = ok ? __ldg(x + row * W + c) : 0.f;
      xim[m][t] = ok ? __ldg(x + row * W + D + c) : 0.f;
      are[m][t] = aim[m][t] = 0.f;
    }
  }

  for (int64_t k0 = jb; k0 < je; k0 += kGradDepth) {
    const int n = je - k0 < kGradDepth ? static_cast<int>(je - k0) : kGradDepth;
    __syncthreads();  // the previous chunk is read
    for (int e = threadIdx.x; e < kGradDepth * BD; e += kThreads) {
      const int jj = e / BD, c = c0 + e % BD;
      const bool ok = jj < n && c < D;
      const float* yp = y + (k0 + jj) * W + c;
      ys[0][jj][e % BD] = ok ? __ldg(yp) : 0.f;
      ys[1][jj][e % BD] = ok ? __ldg(yp + D) : 0.f;
    }
    for (int e = threadIdx.x; e < kGradDepth * kGradRows; e += kThreads) {
      // along g's contiguous axis: i for dp's g (J, I), j for dq's g (I, J)
      const int jj = kDp ? e / kGradRows : e % kGradDepth;
      const int mm = kDp ? e % kGradRows : e / kGradDepth;
      const int64_t i = i0 + mm, j = k0 + jj;
      float w = 0.f;
      if (jj < n && i < I) w = __ldg(kDp ? g + j * I + i : g + i * J + j);
      ws[jj][mm] = w;
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      float yre[TD], yim[TD], w[TM];
#pragma unroll
      for (int t = 0; t < TD; ++t) {
        yre[t] = ys[0][jj][lane + 32 * t];
        yim[t] = ys[1][jj][lane + 32 * t];
      }
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[jj][warp * TM + 4 * h]);
        w[4 * h] = v.x;
        w[4 * h + 1] = v.y;
        w[4 * h + 2] = v.z;
        w[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int t = 0; t < TD; ++t) {
          const float dx = xre[m][t] - yre[t], dy = xim[m][t] - yim[t];
          const float r = rsqrt_approx(fmaf(dy, dy, fmaf(dx, dx, FLT_MIN)));
          are[m][t] = fmaf(w[m], dx * r, are[m][t]);
          aim[m][t] = fmaf(w[m], dy * r, aim[m][t]);
        }
      }
    }
  }

  float* o = out + static_cast<int64_t>(blockIdx.z) * I * W;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t row = i0 + warp * TM + m;
    if (row >= I) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int c = c0 + lane + 32 * t;
      if (c < D) {
        o[row * W + c] = -are[m][t];
        o[row * W + D + c] = -aim[m][t];
      }
    }
  }
}

// out[e] = partials[0][e] + partials[1][e] + ... in split order.
__global__ void __launch_bounds__(kThreads)
    rotate_pool_combine_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               const int64_t n, const int nsplit) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride) {
    float a = partials[e];
    for (int z = 1; z < nsplit; ++z) a += partials[z * n + e];
    out[e] = a;
  }
}

cudaError_t combine(const float* partials, float* out, int64_t n, int nsplit,
                    cudaStream_t st) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;  // a grid-stride loop covers the rest
  rotate_pool_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      partials, out, n, nsplit);
  return cudaGetLastError();
}

template <int TD>
void launch_grad(const float* x, const float* y, const float* g, float* out, int64_t I,
                 int64_t J, int D, int64_t jper, int dp, const dim3& grid, cudaStream_t s) {
  if (dp) {
    rotate_pool_grad_kernel<TD, true><<<grid, kThreads, 0, s>>>(x, y, g, out, I, J, D, jper);
  } else {
    rotate_pool_grad_kernel<TD, false><<<grid, kThreads, 0, s>>>(x, y, g, out, I, J, D, jper);
  }
}

}  // namespace

extern "C" {

// S (I, J) = -sum_c |x[i, c] - y[j, c]| for x (I, 2D), y (J, 2D) complex
// rows (real parts first), all fp32, contiguous. `nsplit` ranges of the
// complex dimensions, whose partial S go to `scratch` (nsplit, I, J) and
// are then added in order into `s` by a second launch (scratch unused
// where nsplit == 1). Launches on `stream`; returns cudaGetLastError() (0
// when launched).
int skge_rotate_pool_forward_f32(const void* x, const void* y, void* s, void* scratch,
                                 int64_t I, int64_t J, int64_t D, int nsplit, void* stream) {
  if (D < 1 || D >= 0x3fffffff || nsplit < 1 || nsplit > D || nsplit > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (I <= 0 || J <= 0) return 0;
  const int64_t gx = (J + kFwdTile - 1) / kFwdTile, gy = (I + kFwdTile - 1) / kFwdTile;
  if (gx > 0x7fffffff || gy > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const int cper = static_cast<int>((D + nsplit - 1) / nsplit);
  const auto st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(nsplit > 1 ? scratch : s);
  rotate_pool_forward_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                                    static_cast<unsigned>(nsplit)),
                               kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), dst, I, J,
      static_cast<int>(D), cper);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(combine(dst, static_cast<float*>(s), I * J, nsplit, st));
}

// One gradient of S: dq (dp == 0: x = q (I, 2D), y = p (J, 2D), g (I, J))
// or dp (dp != 0: x = p (I, 2D), y = q (J, 2D), g (J, I)), into out
// (I, 2D). `td` (1 or 2) complex dimensions a lane; `nsplit` ranges of the
// reduced rows, whose partial sums go to `scratch` (nsplit, I, 2D) and are
// then added in order into `out` by a second launch (scratch unused where
// nsplit == 1). All fp32, contiguous.
int skge_rotate_pool_grad_f32(const void* x, const void* y, const void* g, void* out,
                              void* scratch, int64_t I, int64_t J, int64_t D, int td, int dp,
                              int nsplit, void* stream) {
  if (td < 1 || td > kMaxTd || nsplit < 1 || nsplit > 65535 || D < 1 || D >= 0x3fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (I <= 0) return 0;
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
  if (td == 1) {
    launch_grad<1>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st);
  } else {
    launch_grad<2>(xp, yp, gp, dst, I, J, d, jper, dp, grid, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(combine(dst, static_cast<float*>(out), I * 2 * D, nsplit, st));
}

const char* skge_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
