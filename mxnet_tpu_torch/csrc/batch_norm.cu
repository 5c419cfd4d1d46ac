// Train-mode BatchNorm forward (K1) and backward (K2) for Hopper (sm_90a),
// f32 in and out, f32 statistics merged in f64.
//
// Replaces mxnet_tpu/ops/bn_pallas.py::_bn_fwd_kernel (reached through
// _bn_fwd_call) and ::_bn_bwd_kernel (through _bn_bwd_call).  Same
// function, not the same blocks:
//
//   K1: mean = E[x], var = E[(x - mean)^2] (biased) per channel,
//       rstd = 1 / sqrt(var + eps), scale = gamma * rstd (rstd under
//       fix_gamma), shift = beta - mean * scale,
//       y = x * scale + shift, optionally max(y, 0).
//   K2: g' = g masked by (x * scale + shift > 0) when the ReLU was fused,
//       dbeta = sum g', dgamma = sum g' * xhat, xhat = (x - mean) * rstd,
//       dx = gamma * rstd * (g' - dbeta / m - xhat * dgamma / m).
//
// Layout: x is NCHW-contiguous (any rank: N, C, then the spatial dims
// flattened to S), the layout cuDNN leaves convolution outputs in.
// Channel c is N strips of S contiguous floats.  The TPU kernel's
// (S, N, C) view would be a real transpose here, so it is not built.
//
// What bounds it: both kernels are bound by bytes (a few operations per
// element against 3.35 TB/s).  The least traffic is K1: read x once,
// write y once; K2: read x and g once, write dx once.  This design reads
// more (K1: x twice; K2: x and g twice) to stay simple and exact:
//   * Work per channel differs by 2000x in one ResNet-50 step (3
//     channels of 6.4 M elements at bn_data, 2048 of 6272 at the last
//     BN), so one block per channel would leave most SMs idle.  Each
//     channel is cut into chunks of 4096 elements, one 256-thread block
//     per (chunk, channel): grid = (chunks, C).
//   * Statistics: each block keeps its chunk in registers (16 floats a
//     thread), takes the chunk mean, then the chunk's sum of squared
//     deviations from it (two passes over registers, one read of x), and
//     writes (mean, M2).  A finalize kernel, one warp per channel, merges
//     the chunks by Chan's rule in f64 in a fixed order.  The variance
//     never forms E[x^2] - E[x]^2, which cancels at bn_data (raw pixels,
//     mean >> std), and no atomics are used, so a run repeats bit for bit.
//   * A third kernel normalizes (K1) or forms dx (K2) over the same grid.
//   * Strips at 7x7 are 49 floats, not 16-byte aligned: loads are scalar
//     and coalesced along the flattened (n, s) index of the channel.
// The ReLU mask is recomputed in K2 with the same rounded expression as in
// K1 (__fmul_rn / __fadd_rn, no contraction), so the two agree at
// pre ~ 0; the plain PyTorch version rounds the same way.
// Keeping a chunk resident across the reduction (one read of x) needs a
// grid-wide barrier or a cluster; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int PER_THREAD = 16;          // elements a thread holds
constexpr int CHUNK = NT * PER_THREAD;  // elements of one channel per block
constexpr int NWARP = NT / 32;

// Offset of element i (0 <= i < N*S) of channel c in NC[S] layout.
__device__ __forceinline__ long long elem_offset(unsigned i, int c, int C,
                                                 unsigned S) {
  const unsigned n = i / S;
  const unsigned s = i - n * S;
  return ((long long)n * C + c) * (long long)S + s;
}

__device__ __forceinline__ void scale_shift(float mean, float var,
                                            float gamma, float beta,
                                            float eps, int fix_gamma,
                                            float& rstd, float& scale,
                                            float& shift) {
  rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  scale = fix_gamma ? rstd : __fmul_rn(gamma, rstd);
  shift = __fsub_rn(beta, __fmul_rn(mean, scale));
}

__device__ __forceinline__ float pre_act(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `a` and of `b` over the block, in a fixed order; every thread
// gets both results.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float red[2][NWARP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < NWARP ? red[0][lane] : 0.f;
    float tb = lane < NWARP ? red[1][lane] : 0.f;
    ta = warp_sum(ta);
    tb = warp_sum(tb);
    if (lane == 0) {
      red[0][0] = ta;
      red[1][0] = tb;
    }
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
  __syncthreads();
}

__device__ __forceinline__ void chan_merge(double& n_a, double& mean_a,
                                           double& m2_a, double n_b,
                                           double mean_b, double m2_b) {
  if (n_b == 0.0) return;
  const double n = n_a + n_b;
  const double delta = mean_b - mean_a;
  mean_a += delta * (n_b / n);
  m2_a += m2_b + delta * delta * (n_a * n_b / n);
  n_a = n;
}

// ---- K1 ------------------------------------------------------------------
// part[(c * chunks + chunk) * 2 + {0, 1}] = (chunk mean, chunk M2)
__global__ void __launch_bounds__(NT)
bn_fwd_stats(const float* __restrict__ x, float* __restrict__ part, int C,
             unsigned S, unsigned m, int chunks) {
  const int c = blockIdx.y, chunk = blockIdx.x;
  const unsigned base = (unsigned)chunk * CHUNK;
  const unsigned cnt = min((unsigned)CHUNK, m - base);
  float v[PER_THREAD];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned j = k * NT + threadIdx.x;
    v[k] = j < cnt ? x[elem_offset(base + j, c, C, S)] : 0.f;
    sum += v[k];
  }
  float dummy = 0.f;
  block_sum2(sum, dummy);
  const float mean = sum / (float)cnt;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned j = k * NT + threadIdx.x;
    const float d = j < cnt ? v[k] - mean : 0.f;
    m2 += d * d;
  }
  block_sum2(m2, dummy);
  if (threadIdx.x == 0) {
    part[((size_t)c * chunks + chunk) * 2 + 0] = mean;
    part[((size_t)c * chunks + chunk) * 2 + 1] = m2;
  }
}

// One warp per channel: merge the chunks, write mean/var and the
// (scale, shift) pair the apply kernel uses.
__global__ void __launch_bounds__(NT)
bn_fwd_finalize(const float* __restrict__ part,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ mean_out,
                float* __restrict__ var_out, float* __restrict__ coef, int C,
                unsigned m, int chunks, float eps, int fix_gamma) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (c >= C) return;
  double n_a = 0.0, mean_a = 0.0, m2_a = 0.0;
  for (int j = lane; j < chunks; j += 32) {
    const double n_b = (double)min((unsigned)CHUNK, m - (unsigned)j * CHUNK);
    chan_merge(n_a, mean_a, m2_a, n_b, part[((size_t)c * chunks + j) * 2],
               part[((size_t)c * chunks + j) * 2 + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double n_b = __shfl_down_sync(0xffffffffu, n_a, off);
    const double mean_b = __shfl_down_sync(0xffffffffu, mean_a, off);
    const double m2_b = __shfl_down_sync(0xffffffffu, m2_a, off);
    if (lane + off < 32) chan_merge(n_a, mean_a, m2_a, n_b, mean_b, m2_b);
  }
  if (lane == 0) {
    const float mean = (float)mean_a;
    const float var = (float)(m2_a / (double)m);
    mean_out[c] = mean;
    var_out[c] = var;
    float rstd, scale, shift;
    scale_shift(mean, var, gamma[c], beta[c], eps, fix_gamma, rstd, scale,
                shift);
    coef[2 * c] = scale;
    coef[2 * c + 1] = shift;
  }
}

__global__ void __launch_bounds__(NT)
bn_fwd_apply(const float* __restrict__ x, float* __restrict__ y,
             const float* __restrict__ coef, int C, unsigned S, unsigned m,
             int relu) {
  const int c = blockIdx.y;
  const unsigned base = (unsigned)blockIdx.x * CHUNK;
  const float scale = coef[2 * c], shift = coef[2 * c + 1];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned i = base + k * NT + threadIdx.x;
    if (i < m) {
      const long long off = elem_offset(i, c, C, S);
      const float pre = pre_act(x[off], scale, shift);
      y[off] = (relu && pre < 0.f) ? 0.f : pre;
    }
  }
}

// ---- K2 ------------------------------------------------------------------
struct BwdCoef {
  float mean, rstd, scale, shift;
};

__device__ __forceinline__ BwdCoef bwd_coef(const float* mean,
                                            const float* var,
                                            const float* gamma,
                                            const float* beta, int c,
                                            float eps, int fix_gamma) {
  BwdCoef k;
  k.mean = mean[c];
  scale_shift(k.mean, var[c], gamma[c], beta[c], eps, fix_gamma, k.rstd,
              k.scale, k.shift);
  return k;
}

// part[(c * chunks + chunk) * 2 + {0, 1}] = (sum g', sum g' * xhat)
__global__ void __launch_bounds__(NT)
bn_bwd_reduce(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              float* __restrict__ part, int C, unsigned S, unsigned m,
              int chunks, float eps, int fix_gamma, int relu) {
  const int c = blockIdx.y, chunk = blockIdx.x;
  const BwdCoef k = bwd_coef(mean, var, gamma, beta, c, eps, fix_gamma);
  const unsigned base = (unsigned)chunk * CHUNK;
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const unsigned i = base + t * NT + threadIdx.x;
    if (i < m) {
      const long long off = elem_offset(i, c, C, S);
      const float xv = x[off];
      float gv = g[off];
      if (relu && !(pre_act(xv, k.scale, k.shift) > 0.f)) gv = 0.f;
      const float xhat = __fmul_rn(__fsub_rn(xv, k.mean), k.rstd);
      sg += gv;
      sgx += gv * xhat;
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    part[((size_t)c * chunks + chunk) * 2 + 0] = sg;
    part[((size_t)c * chunks + chunk) * 2 + 1] = sgx;
  }
}

// One warp per channel: dbeta, dgamma and the dx coefficients
// coef[3c..3c+2] = (gamma * rstd, dbeta / m, dgamma / m).
__global__ void __launch_bounds__(NT)
bn_bwd_finalize(const float* __restrict__ part,
                const float* __restrict__ var,
                const float* __restrict__ gamma, float* __restrict__ dgamma,
                float* __restrict__ dbeta, float* __restrict__ coef, int C,
                unsigned m, int chunks, float eps, int fix_gamma) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (c >= C) return;
  double sg = 0.0, sgx = 0.0;
  for (int j = lane; j < chunks; j += 32) {
    sg += (double)part[((size_t)c * chunks + j) * 2];
    sgx += (double)part[((size_t)c * chunks + j) * 2 + 1];
  }
  sg = warp_sum(sg);
  sgx = warp_sum(sgx);
  if (lane == 0) {
    const float db = (float)sg, dg = (float)sgx;
    dbeta[c] = db;
    dgamma[c] = dg;
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var[c], eps)));
    coef[3 * c] = fix_gamma ? rstd : gamma[c] * rstd;
    coef[3 * c + 1] = db / (float)m;
    coef[3 * c + 2] = dg / (float)m;
  }
}

__global__ void __launch_bounds__(NT)
bn_bwd_dx(const float* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ mean, const float* __restrict__ var,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          const float* __restrict__ coef, float* __restrict__ dx, int C,
          unsigned S, unsigned m, float eps, int fix_gamma, int relu) {
  const int c = blockIdx.y;
  const BwdCoef k = bwd_coef(mean, var, gamma, beta, c, eps, fix_gamma);
  const float kk = coef[3 * c], a = coef[3 * c + 1], b = coef[3 * c + 2];
  const unsigned base = (unsigned)blockIdx.x * CHUNK;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const unsigned i = base + t * NT + threadIdx.x;
    if (i < m) {
      const long long off = elem_offset(i, c, C, S);
      const float xv = x[off];
      float gv = g[off];
      if (relu && !(pre_act(xv, k.scale, k.shift) > 0.f)) gv = 0.f;
      const float xhat = __fmul_rn(__fsub_rn(xv, k.mean), k.rstd);
      dx[off] = kk * (gv - a - xhat * b);
    }
  }
}

inline int chunks_of(unsigned m) { return (int)((m + CHUNK - 1) / CHUNK); }

}  // namespace

// Floats of work space one call needs: the (channel, chunk) partials, 2
// floats each, then the per-channel coefficients, 2 floats for K1 and 3
// for K2.  -1 for a shape the kernels do not take: C above 65535 (grid.y)
// or N*S so large that a chunk's unsigned index could overflow.  The
// wrappers size their allocation from this, so the layout lives here only.
extern "C" long long mxtt_bn_work_floats(long long N, long long C,
                                         long long S, int bwd) {
  const long long m = N * S;
  if (N <= 0 || C <= 0 || S <= 0 || C > 65535 || m > (1LL << 31) - CHUNK)
    return -1;
  return C * chunks_of((unsigned)m) * 2 + C * (bwd ? 3 : 2);
}

// Each function launches its three kernels on `stream` into `work` (sized
// by mxtt_bn_work_floats) and returns the first cudaGetLastError() that is
// not 0 (0 when all were taken).
extern "C" int mxtt_bn_fwd(const float* x, const float* gamma,
                           const float* beta, float* y, float* mean,
                           float* var, float* work, int N, int C, int S,
                           float eps, int fix_gamma, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned m = (unsigned)N * (unsigned)S;
  const int chunks = chunks_of(m);
  float* part = work;
  float* coef = work + (size_t)C * chunks * 2;
  const dim3 grid(chunks, C);
  bn_fwd_stats<<<grid, NT, 0, st>>>(x, part, C, (unsigned)S, m, chunks);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bn_fwd_finalize<<<(C + NWARP - 1) / NWARP, NT, 0, st>>>(
      part, gamma, beta, mean, var, coef, C, m, chunks, eps, fix_gamma);
  err = (int)cudaGetLastError();
  if (err) return err;
  bn_fwd_apply<<<grid, NT, 0, st>>>(x, y, coef, C, (unsigned)S, m, relu);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_bn_bwd(const float* x, const float* g, const float* mean,
                           const float* var, const float* gamma,
                           const float* beta, float* dx, float* dgamma,
                           float* dbeta, float* work, int N, int C, int S,
                           float eps, int fix_gamma, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned m = (unsigned)N * (unsigned)S;
  const int chunks = chunks_of(m);
  float* part = work;
  float* coef = work + (size_t)C * chunks * 2;
  const dim3 grid(chunks, C);
  bn_bwd_reduce<<<grid, NT, 0, st>>>(x, g, mean, var, gamma, beta, part, C,
                                     (unsigned)S, m, chunks, eps, fix_gamma,
                                     relu);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bn_bwd_finalize<<<(C + NWARP - 1) / NWARP, NT, 0, st>>>(
      part, var, gamma, dgamma, dbeta, coef, C, m, chunks, eps, fix_gamma);
  err = (int)cudaGetLastError();
  if (err) return err;
  bn_bwd_dx<<<grid, NT, 0, st>>>(x, g, mean, var, gamma, beta, coef, dx, C,
                                 (unsigned)S, m, eps, fix_gamma, relu);
  return (int)cudaGetLastError();
}
