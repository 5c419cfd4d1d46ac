// Train-mode BatchNorm forward (K1) and backward (K2) for Hopper (sm_90a),
// f32 in and out, statistics merged in f64.
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
// What bounds it: bytes, a few operations per element against 3.35 TB/s.
// The least traffic is K1: read x once and write y once, 8 bytes an
// element; K2: read x and g once and write dx once, 12 bytes.  The TPU
// kernel meets that by holding whole channels in VMEM.  Here one channel
// lives in the shared memory of a thread-block cluster (the resident
// path, one launch a call):
//   * A cluster of k CTAs owns one channel; CTA r holds the strips
//     [r * spc, (r + 1) * spc) of it (x, and for K2 also g) in dynamic
//     shared memory.  k is the smallest cluster (at most 16, a
//     non-portable size) whose CTAs each hold at most CTA_BYTES: at
//     N = 128, 8 CTAs at 56x56 for K1 and 16 for K2, 2 and 4 at 28x28,
//     one CTA from 14x14 down.  A CTA that holds a small channel may hold
//     several, as long as the grid still gives every SM four CTAs.
//   * Strips of S % 4 == 0 floats (16-byte aligned) arrive by one bulk
//     copy each (cp.async.bulk, 1-D TMA) completing on an mbarrier; other
//     strips (7x7: 49 floats) by 4-byte cp.async along the channel's
//     flattened (n, s) index.  Strip and offset are stepped, never divided
//     per element; y and dx leave as 16-byte (or 4-byte) stores.
//   * K1: each CTA takes its part's mean from shared memory, then its
//     part's sum of squared deviations about that mean (two passes over
//     shared memory, never E[x^2] - E[x]^2, which cancels at raw-pixel
//     inputs), summing per-thread f32 terms in f64.  It stores (mean, M2)
//     into every CTA of its cluster (distributed shared memory); after one
//     cluster barrier each CTA merges the k parts by Chan's rule in f64 in
//     rank order, so all hold the same statistics, and writes y from
//     shared memory.
//   * K2: the same plan over x and g: the part sums of g' and g' * xhat,
//     exchanged and summed in f64 in rank order, then dx from shared
//     memory.
//   * No atomics and fixed orders everywhere: a run repeats bit for bit.
// Where it does not meet the bound: a channel larger than 16 CTAs hold
// (bn_data, 3 x 224 x 224, and bn0 at 112 x 112 in ResNet-50 at N = 128:
// 25.7 and 6.4 MB of x) takes the chunked path, three kernels over
// (4096-element chunk, channel) blocks: chunk statistics in registers,
// a finalize kernel that merges them by Chan's rule in f64, then a third
// kernel that reads x (and g) again: 12 bytes an element for K1, 20 for
// K2.  make_plan picks the path from the shape; mxtt_bn_plan reports it.
// The ReLU mask is recomputed in K2 with the same rounded expression as in
// K1 (__fmul_rn / __fadd_rn, no contraction), so the two agree at
// pre ~ 0; the plain PyTorch version rounds the same way.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

// -- the chunked path
constexpr int NT = 256;                 // threads per block
constexpr int PER_THREAD = 16;          // elements a thread holds
constexpr int CHUNK = NT * PER_THREAD;  // elements of one channel per block
constexpr int NWARP = NT / 32;

// -- the resident path
// threads per CTA of K1 and of K2, each the faster of 256 and 512 over
// the ResNet-50 shapes (chip_bn_costs.py)
constexpr int RT_FWD = 256;
constexpr int RT_BWD = 512;
constexpr int MAX_CL = 16;              // CTAs per cluster (above 8: non-portable)
constexpr int MAX_CPC = 8;              // channels per CTA
constexpr long long CTA_BYTES = 200 * 1024;       // a CTA's share of a channel
constexpr long long SMALL_CTA_BYTES = 48 * 1024;  // a CTA of several channels
constexpr int SMEM_LIMIT = 232448;      // shared memory one block may use
constexpr int STATIC_SMEM = 1024;       // kept for the kernels' static arrays
constexpr int MAX_DEVICES = 64;

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

// Sum over the warp, in a fixed order; lane 0 holds it.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `a` and of `b` over a block of NTH threads, in a fixed order;
// every thread gets both results.
template <int NTH, typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  constexpr int NW = NTH / 32;
  __shared__ T red[2][NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    T ta = lane < NW ? red[0][lane] : T(0);
    T tb = lane < NW ? red[1][lane] : T(0);
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

// ---- copies and barriers of the resident path -----------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the mbarrier inits visible to the bulk copies (the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once on `bar`, which then also waits for `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device memory into this CTA's shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The two halves of a cluster barrier, apart: a CTA arrives once its
// copies are under way and waits before its first store into another
// CTA's shared memory, which must be running by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// VEC floats at p: one 16-byte access for VEC = 4.
template <int VEC>
__device__ __forceinline__ void ld(float (&r)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
    r[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void st(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else
    *p = r[0];
}

// Where unit q (VEC floats) of a CTA's part lies: strip j of the part,
// unit v of the strip (sv units a strip).  Thread t of NTH visits q = t,
// t + NTH, ...; step() moves on by NTH units without a division.
struct Walk {
  int j, v, dj, dv, sv;
  __device__ __forceinline__ Walk(int q, int sv_, int nth) : sv(sv_) {
    j = q / sv;
    v = q - j * sv;
    dj = nth / sv;
    dv = nth - dj * sv;
  }
  __device__ __forceinline__ void step() {
    v += dv;
    j += dj;
    if (v >= sv) {
      v -= sv;
      ++j;
    }
  }
};

// Starts the copies of strips [n0, n0 + ns) of channel c of t into dst
// (ns * S floats).  VEC = 4: one bulk copy a strip, issued by the lanes of
// warp 0 (the only caller) and counted on bar, whose bytes the caller
// posted; VEC = 1: 4-byte cp.async by every thread along the flattened
// (strip, s) index, committed by the caller.
template <int VEC, int NTH>
__device__ __forceinline__ void load_part(float* dst, const float* t, int c,
                                          int C, int S, int n0, int ns,
                                          uint64_t* bar) {
  if constexpr (VEC == 4) {
    for (int j = threadIdx.x; j < ns; j += 32)
      bulk_load(dst + (size_t)j * S, t + ((long long)(n0 + j) * C + c) * S,
                (unsigned)S * 4u, bar);
  } else {
    Walk w(threadIdx.x, S, NTH);
    for (int q = threadIdx.x; q < ns * S; q += NTH, w.step())
      cp_async4(dst + q, t + ((long long)(n0 + w.j) * C + c) * S + w.v);
  }
}

// Starts every copy of a resident CTA: x (and for PLANES = 2 also g) of
// each of its nch channels, channel ch's at part + ch * pitch, g's at
// + spc * S.  VEC = 4 counts channel ch on bar[ch].
template <int VEC, int NTH, int PLANES>
__device__ __forceinline__ void load_channels(
    float* part, const float* x, const float* g, int c0, int nch,
    size_t pitch, int C, int S, int n0, int ns, int spc, uint64_t* bar) {
  if constexpr (VEC == 4) {
    if (threadIdx.x == 0) {
      for (int ch = 0; ch < nch; ++ch) mbar_init(&bar[ch], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int ch = 0; ch < nch; ++ch) {
        if (threadIdx.x == 0)
          mbar_expect_tx(&bar[ch], (unsigned)(PLANES * ns * S * 4));
        __syncwarp();
        for (int p = 0; p < PLANES; ++p)
          load_part<4, NTH>(part + ch * pitch + (size_t)p * spc * S,
                            p ? g : x, c0 + ch, C, S, n0, ns, &bar[ch]);
      }
    }
  } else {
    for (int ch = 0; ch < nch; ++ch)
      for (int p = 0; p < PLANES; ++p)
        load_part<1, NTH>(part + ch * pitch + (size_t)p * spc * S, p ? g : x,
                          c0 + ch, C, S, n0, ns, nullptr);
    cp_async_commit();
  }
}

// Waits until channel ch's copies are in shared memory.
template <int VEC>
__device__ __forceinline__ void wait_channel(uint64_t* bar, int ch) {
  if constexpr (VEC == 4) {
    mbar_wait(&bar[ch], 0);
  } else if (ch == 0) {
    cp_async_wait_all();
    __syncthreads();
  }
}

// ---- K1, resident ------------------------------------------------------------
// Grid: clusters of kcl CTAs; cluster i holds channels [i * cpc, ...) (cpc
// > 1 only when kcl == 1); CTA r of a cluster holds strips [r * spc, ...).
template <int VEC>
__global__ void __launch_bounds__(RT_FWD)
bn_fwd_resident(const float* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ var_out,
                int N, int C, int S, int kcl, int spc, int cpc, float eps,
                int fix_gamma, int relu) {
  extern __shared__ __align__(16) float part[];
  __shared__ uint64_t bar[MAX_CPC];
  __shared__ double2 parts[MAX_CL];  // (mean, M2) of each CTA's part
  const int rank = kcl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (int)(blockIdx.x / kcl) * cpc;
  const int nch = min(cpc, C - c0);
  const int n0 = rank * spc, ns = min(spc, N - n0);
  const int sv = S / VEC, units = ns * sv;
  const size_t pitch = (size_t)spc * S;
  constexpr int NTH = RT_FWD;
  load_channels<VEC, NTH, 1>(part, x, nullptr, c0, nch, pitch, C, S, n0, ns,
                             spc, bar);
  if (kcl > 1) cluster_arrive_relaxed();
  for (int ch = 0; ch < nch; ++ch) {
    const int c = c0 + ch;
    const float* p = part + ch * pitch;
    wait_channel<VEC>(bar, ch);
    float s = 0.f;
    for (int q = threadIdx.x; q < units; q += NTH) {
      float v[VEC];
      ld<VEC>(v, p + q * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += v[i];
    }
    double sum = s, m2 = 0.0;
    block_sum2<NTH>(sum, m2);
    double mean = sum / ((double)ns * S);
    const float mf = (float)mean;
    float d2 = 0.f;
    for (int q = threadIdx.x; q < units; q += NTH) {
      float v[VEC];
      ld<VEC>(v, p + q * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - mf;
        d2 += d * d;
      }
    }
    m2 = d2;
    sum = 0.0;
    block_sum2<NTH>(m2, sum);
    if (kcl > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster_wait();  // every CTA of the cluster runs
      if ((int)threadIdx.x < kcl)
        *cluster.map_shared_rank(&parts[rank], (int)threadIdx.x) =
            make_double2(mean, m2);
      cluster.sync();  // every part is here
      double n_a = 0.0, mean_a = 0.0, m2_a = 0.0;
      for (int r = 0; r < kcl; ++r)
        chan_merge(n_a, mean_a, m2_a, (double)min(spc, N - r * spc) * S,
                   parts[r].x, parts[r].y);
      mean = mean_a;
      m2 = m2_a;
    }
    const float mean_f = (float)mean;
    const float var_f = (float)(m2 / ((double)N * S));
    if (rank == 0 && threadIdx.x == 0) {
      mean_out[c] = mean_f;
      var_out[c] = var_f;
    }
    float rstd, scale, shift;
    scale_shift(mean_f, var_f, gamma[c], beta[c], eps, fix_gamma, rstd,
                scale, shift);
    Walk w(threadIdx.x, sv, NTH);
    for (int q = threadIdx.x; q < units; q += NTH, w.step()) {
      float v[VEC];
      ld<VEC>(v, p + q * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float pre = pre_act(v[i], scale, shift);
        v[i] = (relu && pre < 0.f) ? 0.f : pre;
      }
      st<VEC>(y + ((long long)(n0 + w.j) * C + c) * S + w.v * VEC, v);
    }
  }
}

// ---- K2, resident ------------------------------------------------------------
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

// The same grid as bn_fwd_resident; a CTA holds g beside x.  At VEC = 1
// (7x7 strips, 49 KB a CTA) the bound of three CTAs an SM holds K2 to 40
// registers; left to itself nvcc takes 52, two CTAs fit an SM, and the
// 7x7 shapes run ~10% slower (chip_bn_costs.py).
template <int VEC>
__global__ void __launch_bounds__(RT_BWD, VEC == 1 ? 3 : 1)
bn_bwd_resident(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ mean, const float* __restrict__ var,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ dx,
                float* __restrict__ dgamma, float* __restrict__ dbeta, int N,
                int C, int S, int kcl, int spc, int cpc, float eps,
                int fix_gamma, int relu) {
  extern __shared__ __align__(16) float part[];
  __shared__ uint64_t bar[MAX_CPC];
  __shared__ double2 parts[MAX_CL];  // (sum g', sum g' * xhat) of each part
  const int rank = kcl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (int)(blockIdx.x / kcl) * cpc;
  const int nch = min(cpc, C - c0);
  const int n0 = rank * spc, ns = min(spc, N - n0);
  const int sv = S / VEC, units = ns * sv;
  const size_t pitch = (size_t)2 * spc * S;
  constexpr int NTH = RT_BWD;
  load_channels<VEC, NTH, 2>(part, x, g, c0, nch, pitch, C, S, n0, ns,
                             spc, bar);
  if (kcl > 1) cluster_arrive_relaxed();
  const float m_f = (float)((long long)N * S);
  for (int ch = 0; ch < nch; ++ch) {
    const int c = c0 + ch;
    const float* px = part + ch * pitch;
    const float* pg = px + (size_t)spc * S;
    const BwdCoef k = bwd_coef(mean, var, gamma, beta, c, eps, fix_gamma);
    wait_channel<VEC>(bar, ch);
    float sg = 0.f, sgx = 0.f;
    for (int q = threadIdx.x; q < units; q += NTH) {
      float xv[VEC], gv[VEC];
      ld<VEC>(xv, px + q * VEC);
      ld<VEC>(gv, pg + q * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (relu && !(pre_act(xv[i], k.scale, k.shift) > 0.f)) gv[i] = 0.f;
        const float xhat = __fmul_rn(__fsub_rn(xv[i], k.mean), k.rstd);
        sg += gv[i];
        sgx += gv[i] * xhat;
      }
    }
    double a = sg, b = sgx;
    block_sum2<NTH>(a, b);
    if (kcl > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster_wait();  // every CTA of the cluster runs
      if ((int)threadIdx.x < kcl)
        *cluster.map_shared_rank(&parts[rank], (int)threadIdx.x) =
            make_double2(a, b);
      cluster.sync();  // every part is here
      a = 0.0;
      b = 0.0;
      for (int r = 0; r < kcl; ++r) {
        a += parts[r].x;
        b += parts[r].y;
      }
    }
    const float db = (float)a, dg = (float)b;
    if (rank == 0 && threadIdx.x == 0) {
      dbeta[c] = db;
      dgamma[c] = dg;
    }
    const float kk = fix_gamma ? k.rstd : gamma[c] * k.rstd;
    const float am = db / m_f, bm = dg / m_f;
    Walk u(threadIdx.x, sv, NTH);
    for (int q = threadIdx.x; q < units; q += NTH, u.step()) {
      float xv[VEC], gv[VEC];
      ld<VEC>(xv, px + q * VEC);
      ld<VEC>(gv, pg + q * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (relu && !(pre_act(xv[i], k.scale, k.shift) > 0.f)) gv[i] = 0.f;
        const float xhat = __fmul_rn(__fsub_rn(xv[i], k.mean), k.rstd);
        xv[i] = kk * (gv[i] - am - xhat * bm);
      }
      st<VEC>(dx + ((long long)(n0 + u.j) * C + c) * S + u.v * VEC, xv);
    }
  }
}

// ---- K1, chunked -----------------------------------------------------------
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
  block_sum2<NT>(sum, dummy);
  const float mean = sum / (float)cnt;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const unsigned j = k * NT + threadIdx.x;
    const float d = j < cnt ? v[k] - mean : 0.f;
    m2 += d * d;
  }
  block_sum2<NT>(m2, dummy);
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

// ---- K2, chunked -----------------------------------------------------------
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
  block_sum2<NT>(sg, sgx);
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

// How one call is laid out.  resident: one channel per cluster of k CTAs
// (else the chunked path, and the rest is unset); spc strips per CTA; cpc
// channels per CTA; clusters launched; dynamic shared memory per CTA.
struct Plan {
  int resident = 0, k = 1, spc = 0, cpc = 1;
  long long clusters = 0;
  size_t smem = 0;
};

// The plan for (N, C, S) from the shape alone (sms = the card's SM count;
// 0 leaves cpc at 1, which does not change the path).
Plan make_plan(long long N, long long C, long long S, int bwd, int sms) {
  Plan p;
  const long long row = S * 4 * (bwd ? 2 : 1);  // bytes of a strip (K2: x, g)
  for (long long k = 1; k <= MAX_CL && k <= N; ++k) {
    const long long spc = (N + k - 1) / k;
    if (spc * row <= CTA_BYTES) {
      p.resident = 1;
      p.spc = (int)spc;
      p.k = (int)((N + spc - 1) / spc);  // no CTA without strips
      break;
    }
  }
  if (!p.resident) return p;
  if (p.k == 1 && sms > 0) {
    // several small channels a CTA, while every SM still gets four CTAs
    long long cpc = SMALL_CTA_BYTES / (N * row);
    if (cpc > MAX_CPC) cpc = MAX_CPC;
    if (cpc > C / (4LL * sms)) cpc = C / (4LL * sms);
    p.cpc = cpc > 1 ? (int)cpc : 1;
  }
  p.clusters = (C + p.cpc - 1) / p.cpc;
  p.smem = (size_t)p.cpc * p.spc * row;
  return p;
}

struct DeviceState {
  bool ready = false;
  int sms = 0;
};
std::mutex g_mu;
DeviceState g_devices[MAX_DEVICES];

template <int VEC>
const void* fwd_kernel() {
  return (const void*)bn_fwd_resident<VEC>;
}

template <int VEC>
const void* bwd_kernel() {
  return (const void*)bn_bwd_resident<VEC>;
}

// Once per device: lets the resident kernels take their shared memory and
// clusters above 8; returns the SM count.
int prepare(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState& d = g_devices[dev];
  if (!d.ready) {
    const void* kernels[] = {fwd_kernel<4>(), fwd_kernel<1>(),
                             bwd_kernel<4>(), bwd_kernel<1>()};
    for (const void* k : kernels) {
      err = (int)cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_LIMIT - STATIC_SMEM);
      if (err) return err;
      err = (int)cudaFuncSetAttribute(
          k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err) return err;
    }
    err = (int)cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err) return err;
    d.ready = true;
  }
  *sms = d.sms;
  return 0;
}

void resident_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                     const Plan& p, int bwd, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(p.clusters * p.k));
  cfg->blockDim = dim3(bwd ? RT_BWD : RT_FWD);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

int chunked_fwd(const float* x, const float* gamma, const float* beta,
                float* y, float* mean, float* var, float* work, int N, int C,
                int S, float eps, int fix_gamma, int relu, cudaStream_t st) {
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

int chunked_bwd(const float* x, const float* g, const float* mean,
                const float* var, const float* gamma, const float* beta,
                float* dx, float* dgamma, float* dbeta, float* work, int N,
                int C, int S, float eps, int fix_gamma, int relu,
                cudaStream_t st) {
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

}  // namespace

// Floats of work space one call needs: none on the resident path; on the
// chunked path the (channel, chunk) partials, 2 floats each, then the
// per-channel coefficients, 2 floats for K1 and 3 for K2.  -1 for a shape
// the kernels do not take: C above 65535 (the chunked grid's y) or N*S so
// large that a chunk's unsigned index could overflow.  The wrappers size
// their allocation from this, so the layout lives here only.
extern "C" long long mxtt_bn_work_floats(long long N, long long C,
                                         long long S, int bwd) {
  const long long m = N * S;
  if (N <= 0 || C <= 0 || S <= 0 || C > 65535 || m > (1LL << 31) - CHUNK)
    return -1;
  if (make_plan(N, C, S, bwd, 0).resident) return 0;
  return C * chunks_of((unsigned)m) * 2 + C * (bwd ? 3 : 2);
}

// The layout of K1 (bwd = 0) or K2 (bwd = 1) for (N, C, S) on the current
// device, for reports: out = {1 resident / 0 chunked, CTAs per cluster,
// channels per CTA, strips per CTA, clusters launched, clusters the card
// holds at once, dynamic shared memory bytes per CTA}.  On the chunked
// path a "cluster" is one (chunk, channel) block of its first kernel.
// Returns a CUDA error.
extern "C" int mxtt_bn_plan(long long N, long long C, long long S, int bwd,
                            long long* out) {
  int sms = 0;
  int err = prepare(&sms);
  if (err) return err;
  if (mxtt_bn_work_floats(N, C, S, bwd) < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(N, C, S, bwd, sms);
  int active = 0;
  if (p.resident) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    resident_config(&cfg, &attr, p, bwd, 0);
    const void* kernel = S % 4 == 0 ? (bwd ? bwd_kernel<4>() : fwd_kernel<4>())
                                    : (bwd ? bwd_kernel<1>() : fwd_kernel<1>());
    err = (int)cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err) return err;
  } else {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &active, bwd ? (const void*)bn_bwd_reduce : (const void*)bn_fwd_stats,
        NT, 0);
    if (err) return err;
    active *= sms;
  }
  out[0] = p.resident;
  out[1] = p.k;
  out[2] = p.cpc;
  out[3] = p.resident ? p.spc : 0;
  out[4] = p.resident ? p.clusters
                      : (long long)chunks_of((unsigned)(N * S)) * C;
  out[5] = active;
  out[6] = (long long)p.smem;
  return 0;
}

// Each function launches one kernel (resident path) or three (chunked) on
// `stream`, with `work` sized by mxtt_bn_work_floats, and returns the
// first cudaGetLastError() that is not 0 (0 when all were taken).
extern "C" int mxtt_bn_fwd(const float* x, const float* gamma,
                           const float* beta, float* y, float* mean,
                           float* var, float* work, int N, int C, int S,
                           float eps, int fix_gamma, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  int err = prepare(&sms);
  if (err) return err;
  const Plan p = make_plan(N, C, S, 0, sms);
  if (!p.resident)
    return chunked_fwd(x, gamma, beta, y, mean, var, work, N, C, S, eps,
                       fix_gamma, relu, st);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  resident_config(&cfg, &attr, p, 0, st);
  if (S % 4 == 0 && aligned16(x) && aligned16(y))
    err = (int)cudaLaunchKernelEx(&cfg, bn_fwd_resident<4>, x, gamma, beta,
                                  y, mean, var, N, C, S, p.k, p.spc, p.cpc,
                                  eps, fix_gamma, relu);
  else
    err = (int)cudaLaunchKernelEx(&cfg, bn_fwd_resident<1>, x, gamma, beta,
                                  y, mean, var, N, C, S, p.k, p.spc, p.cpc,
                                  eps, fix_gamma, relu);
  if (err) return err;
  return (int)cudaGetLastError();
}

extern "C" int mxtt_bn_bwd(const float* x, const float* g, const float* mean,
                           const float* var, const float* gamma,
                           const float* beta, float* dx, float* dgamma,
                           float* dbeta, float* work, int N, int C, int S,
                           float eps, int fix_gamma, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  int err = prepare(&sms);
  if (err) return err;
  const Plan p = make_plan(N, C, S, 1, sms);
  if (!p.resident)
    return chunked_bwd(x, g, mean, var, gamma, beta, dx, dgamma, dbeta, work,
                       N, C, S, eps, fix_gamma, relu, st);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  resident_config(&cfg, &attr, p, 1, st);
  if (S % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx))
    err = (int)cudaLaunchKernelEx(
        &cfg, bn_bwd_resident<4>, x, g, mean, var, gamma,
        beta, dx, dgamma, dbeta, N, C, S, p.k, p.spc, p.cpc, eps, fix_gamma,
        relu);
  else
    err = (int)cudaLaunchKernelEx(
        &cfg, bn_bwd_resident<1>, x, g, mean, var, gamma,
        beta, dx, dgamma, dbeta, N, C, S, p.k, p.spc, p.cpc, eps, fix_gamma,
        relu);
  if (err) return err;
  return (int)cudaGetLastError();
}
