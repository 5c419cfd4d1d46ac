// Whole-sequence LSTM kernels for Hopper (sm_90a), f32 in and out:
//   K4 mxtt_lstm_infer  forward without residuals: ys, hT, cT
//   K5 mxtt_lstm_fwd    K4 plus the saved gates (post-activation) and cs
//   K6 mxtt_lstm_bwd    reverse-time backward: dxp, dw4, dbh, dh0, dc0
//
// Replaces mxnet_tpu/ops/rnn_pallas.py::_infer_kernel (reached through
// _run_infer), ::_fwd_kernel (_run_fwd) and ::_bwd_kernel (_run_bwd).  The
// interface keeps that file's layout: xp (T, 4, N, H) input projections,
// w4 (4, H, H) with w4[k] the (in, out) matrix of gate k, bh (4, H), h0
// and c0 (N, H); gate order i, f, g, o.  Per step t:
//   z_k = h @ w4[k];  i, f, o = sigmoid(xp[t,k] + z_k + bh[k]) for
//   k = 0, 1, 3;  g = tanh(xp[t,2] + z_2 + bh[2]);
//   c = f * c + i * g;  h = o * tanh(c).
// Backward, t = T-1 .. 0, with c_prev, h_prev from c0, h0 at t = 0:
//   dh += dys[t];  do = dh * tanh(c);  dc += dh * o * (1 - tanh(c)^2);
//   dz = (dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), do*o*(1-o));
//   dxp[t] = dz;  dh = sum_k dz_k @ w4[k]^T;  dc *= f;
//   dw4[k] = sum_t h_prev^T dz_k;  dbh[k] = sum_t,n dz_k.
//
// What bounds them on this card: neither bytes nor operations but the
// serial chain of T steps.  K5 at T = 60, N = 32, H = 200 moves about
// 16 MB (5 us at 3.35 TB/s) and does 2*4*N*H^2*T = 0.61 GFLOP (9 us at
// the 67 TFLOP/s f32 CUDA-core peak); each step needs the whole previous
// h, so the steps cannot overlap.
//
// K4 and K5, a persistent recurrence on thread-block clusters:
//   * A cluster of CL = 8 CTAs keeps w4 in shared memory, split by the
//     output column j: CTA r owns the columns S = [r*Sz, (r+1)*Sz) of all
//     four gates and holds w4[k][:, S] for k = 0..3 (80 KB at H = 200),
//     the four gates of one (i, j) in one float4.  Where a slice does not
//     fit (H above ~400), its first Sw rows i live in shared memory and
//     the rest stream from L2 in the same step.
//   * Every CTA keeps h, all H columns, of the cluster's R batch rows in
//     an exchange buffer [2][R][H], double-buffered by step parity.  Per
//     step it forms z[r][k][j] = sum_i h[r][i] * w4[k][i][j] for its own
//     j, and the cell update of (r, j) in registers, since all four gates
//     of column j are in this CTA; c of its columns never leaves it.  It
//     writes ys (and for K5 the gates and cs) to device memory and stores
//     h[:, S] into every CTA of the cluster (distributed shared memory);
//     one cluster barrier a step makes the new h visible.
//   * The product is bound by shared-memory reads, not FMAs (40 K FMA
//     per CTA and step at N = 32, H = 200).  A group of FG = 8 lanes
//     takes one column j for RB batch rows: each float4 of w4 feeds RB
//     rows and four gates, the lanes split the i range in fixed chunks,
//     and three shuffles sum the group in a fixed order.
//   * Batch rows never interact, so R rows go to a cluster and the row
//     groups are spread over as many clusters as the card holds at once
//     (fwd_plan; 16 clusters of 2 rows at N = 32, H = 200 on an H100);
//     more groups than clusters loop.
//   * xp of step t+1 is copied into shared memory by cp.async while step
//     t waits at the barrier, each value by the thread that reads it.
//
// K6, a persistent recurrence on thread-block clusters, then the weight
// gradients:
//   * A cluster of CL = 8 CTAs keeps w4 in shared memory, split by the
//     row index i: CTA r owns the slice S = [r*Sz, (r+1)*Sz) of the H
//     indices and holds w4[:, i, :] for i in S (80 KB at H = 200), all
//     four gates of one i in one row.  Where a slice does not fit
//     (H above ~400), its first Sw rows live in shared memory and the
//     rest stream from L2 in the same step.
//   * Per step each CTA forms dz[:, :, S] elementwise from dh[:, S] and
//     dc[:, S], which never leave it, writes it to dxp and stores it into
//     every CTA of the cluster (distributed shared memory, double-
//     buffered by step parity; four threads per element, two CTAs each);
//     one cluster barrier makes all of dz visible, and each CTA forms
//     dh_prev[:, S] = sum_k dz_k w4[k][S, :]^T from its own rows of w4:
//     16 threads per two rows i and two batch rows n, float4 reads along
//     (k, j), a fixed shuffle sum.  No transposed copy of w4 is made.
//   * Batch rows never interact, so R rows go to a cluster and the row
//     groups are spread over as many clusters as the card holds at once
//     (16 clusters of 2 rows at N = 32, H = 200 on an H100); more groups
//     than clusters loop.
//   * What holds it back is no longer the products (0.3 us a step at the
//     f32 peak) but each step's fixed costs: two barriers, the
//     elementwise phase with its DSMEM stores, and the dh product's
//     shared-memory reads (80 KB of w4 and 160 KB of dz per CTA and step
//     at H = 200), bound by shared-memory bandwidth.
//   * What does not depend on the recurrence (gates, cs, c_prev, dys of
//     step t-1) is copied into shared memory by cp.async while step t
//     waits at the barrier and forms dh.
//   * dw4 and dbh reduce over all T and N.  No atomics: a second kernel
//     computes [h_prev; 1]^T (H+1 x T*N) times dz_k (T*N x H) per gate in
//     64x64 output tiles, 4x4 per thread, with the T*N axis split into P
//     fixed chunks so that about four blocks per SM of a 132-SM card
//     work; a third kernel sums the P partial products in order.  Runs
//     repeat bit for bit.
// Numerics: expf-based sigmoid and tanhf in f32, no fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_H = 1024;   // the widest H the three kernels take
constexpr int CL = 8;         // CTAs per cluster (the portable maximum)
constexpr int BT = 256;       // threads per CTA of K4/K5 and K6
constexpr int FG = 8;         // K4/K5: lanes that share one column's products
constexpr int FR = 2;         // K4/K5: batch rows per register block
constexpr int RB = 4;         // batch rows per register block of dh
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use
constexpr int DWT = 64;       // dw4 output tile (DWT x DWT)
constexpr int DWK = 32;       // T*N values per stage of the dw4 product
constexpr int DW_THREADS = 256;
constexpr int DW_BLOCKS = 528;  // about four blocks per SM of a 132-SM card

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- K4 and K5 ---------------------------------------------------------------
// Floats of a K4/K5 CTA's shared memory besides its rows of w4: the h
// exchange [2][R][H], c [R][Sz], the xp prefetch [2][4][R][Sz] and bh's
// slice [4][Sz].
inline size_t fwd_fixed_floats(int R, int H, int Sz) {
  return (size_t)R * (2 * H + 9 * Sz) + 4 * (size_t)Sz;
}

// xp[t] of the elements whose cell update this thread does -> pre[4][R][Sz]:
// lane s of the group that takes (column jl, rows nb..) copies row nb + s.
__device__ __forceinline__ void fwd_prefetch(float* pre,
                                             const float* __restrict__ xp,
                                             int t, int n0, int rows, int j0,
                                             int sz, int N, int H, int RS,
                                             int Sz) {
  const int s = threadIdx.x % FG;
  const int ntask = sz * ((rows + FR - 1) / FR);
  const size_t NH = (size_t)N * H;
  for (int u = threadIdx.x / FG; u < ntask; u += BT / FG) {
    const int jl = u % sz, r = (u / sz) * FR + s;
    if (s >= FR || r >= rows) continue;
    const size_t xo = ((size_t)t * 4 * N + n0 + r) * H + j0 + jl;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cp_async4(pre + k * RS + r * Sz + jl, xp + xo + k * NH);
  }
}

// K4 (SAVE = false) and K5 (SAVE = true): clusters of CL CTAs, CTA `rank`
// owning the columns [rank*Sz, rank*Sz + sz) of every gate; R batch rows
// per cluster pass, taken FR at a time; rows i < Sw of the slice of w4 in
// shared memory, laid out [i][P] as float4 (gates i, f, g, o) with an odd
// pitch P; lane s of a group sums i in [s*chunk, (s+1)*chunk) (chunk odd,
// so the eight lanes' float4 reads fall in distinct banks).
template <bool SAVE>
__global__ void __launch_bounds__(BT)
    lstm_fwd_cluster_kernel(const float* __restrict__ xp,
                            const float* __restrict__ w4,
                            const float* __restrict__ bh,
                            const float* __restrict__ h0,
                            const float* __restrict__ c0,
                            float* __restrict__ ys, float* __restrict__ gates,
                            float* __restrict__ cs, float* __restrict__ hT,
                            float* __restrict__ cT, int T, int N, int H,
                            int R, int Sz, int P, int Sw, int chunk) {
  extern __shared__ float4 sm4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int nclusters = gridDim.x / CL;
  const int j0 = rank * Sz;
  const int sz = max(0, min(Sz, H - j0));
  const int RS = R * Sz;
  float4* w4s = sm4;                                 // [Sw][P]
  float* hx = reinterpret_cast<float*>(sm4 + (size_t)Sw * P);  // [2][R][H]
  float* cb = hx + 2 * R * H;                        // [R][Sz]
  float* pre = cb + RS;                              // [2][4][R][Sz]
  float* bs = pre + 8 * RS;                          // [4][Sz]
  const size_t NH = (size_t)N * H;
  const int lane = threadIdx.x & 31;
  const int s = lane % FG;
  const unsigned group = 0xFFu << (lane & ~(FG - 1));
  const int i0 = s * chunk, i1 = min(H, i0 + chunk), im = min(i1, Sw);

  float* w4f = reinterpret_cast<float*>(w4s);
  for (int idx = threadIdx.x; idx < Sw * 4 * sz; idx += BT) {
    const int i = idx / (4 * sz);
    const int rem = idx - i * 4 * sz;
    const int k = rem / sz, jl = rem - k * sz;
    w4f[((size_t)i * P + jl) * 4 + k] = w4[((size_t)k * H + i) * H + j0 + jl];
  }
  for (int idx = threadIdx.x; idx < 4 * sz; idx += BT) {
    const int k = idx / sz, jl = idx - k * sz;
    bs[k * Sz + jl] = bh[k * H + j0 + jl];
  }
  cluster.sync();  // every CTA of the cluster runs, w4s is loaded

  const int ngroups = (N + R - 1) / R;
  int step = 0;  // counts steps across row groups: the buffer parity
  for (int grp = cid; grp < ngroups; grp += nclusters) {
    const int n0 = grp * R;
    const int rows = min(R, N - n0);
    const int ntask = sz * ((rows + FR - 1) / FR);
    __syncthreads();  // the last group's hT and cT are read
    float* h_init = hx + (step & 1) * R * H;
    for (int e = threadIdx.x; e < rows * H; e += BT)
      h_init[e] = h0[(size_t)n0 * H + e];
    for (int e = threadIdx.x; e < rows * sz; e += BT) {
      const int r = e / sz, jl = e - r * sz;
      cb[r * Sz + jl] = c0[(size_t)(n0 + r) * H + j0 + jl];
    }
    fwd_prefetch(pre + (step & 1) * 4 * RS, xp, 0, n0, rows, j0, sz, N, H,
                 RS, Sz);
    cp_async_commit();
    __syncthreads();  // h0 and c0 are in place
    for (int t = 0; t < T; ++t, ++step) {
      const int buf = step & 1;
      const float* hc = hx + buf * R * H;
      const float* pb = pre + buf * 4 * RS;
      cp_async_wait_all();  // this thread's xp[t] values are in pb
      for (int u = threadIdx.x / FG; u < ntask; u += BT / FG) {
        const int jl = u % sz, nb = (u / sz) * FR;
        const int nrow = min(FR, rows - nb);
        const float* hr[FR];
#pragma unroll
        for (int r = 0; r < FR; ++r)
          hr[r] = hc + min(nb + r, rows - 1) * H;  // a row past the group
                                                   // repeats the last
        float acc[FR][4];
#pragma unroll
        for (int r = 0; r < FR; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll 4
        for (int i = i0; i < im; ++i) {
          const float4 w = w4s[i * P + jl];
#pragma unroll
          for (int r = 0; r < FR; ++r) {
            const float hv = hr[r][i];
            acc[r][0] = fmaf(hv, w.x, acc[r][0]);
            acc[r][1] = fmaf(hv, w.y, acc[r][1]);
            acc[r][2] = fmaf(hv, w.z, acc[r][2]);
            acc[r][3] = fmaf(hv, w.w, acc[r][3]);
          }
        }
        // rows of the slice past Sw, read from device memory (L2)
        const float* wg = w4 + j0 + jl;
        for (int i = max(i0, Sw); i < i1; ++i) {
          const size_t o = (size_t)i * H;
          const float w0 = __ldg(wg + o), w1 = __ldg(wg + H * (size_t)H + o);
          const float w2 = __ldg(wg + 2 * H * (size_t)H + o);
          const float w3 = __ldg(wg + 3 * H * (size_t)H + o);
#pragma unroll
          for (int r = 0; r < FR; ++r) {
            const float hv = hr[r][i];
            acc[r][0] = fmaf(hv, w0, acc[r][0]);
            acc[r][1] = fmaf(hv, w1, acc[r][1]);
            acc[r][2] = fmaf(hv, w2, acc[r][2]);
            acc[r][3] = fmaf(hv, w3, acc[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < FR; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int off = FG / 2; off > 0; off >>= 1)
              acc[r][k] += __shfl_xor_sync(group, acc[r][k], off);
        // lane s updates row nb + s of column jl
        float h = 0.f;
        if (s < nrow) {
          float z[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            z[k] = acc[0][k];
#pragma unroll
            for (int r = 1; r < FR; ++r)
              if (s == r) z[k] = acc[r][k];
          }
          const int r = nb + s, n = n0 + r, j = j0 + jl;
          const int q = r * Sz + jl;
          const float gi = sigm((pb[q] + z[0]) + bs[jl]);
          const float gf = sigm((pb[RS + q] + z[1]) + bs[Sz + jl]);
          const float gg = tanhf((pb[2 * RS + q] + z[2]) + bs[2 * Sz + jl]);
          const float go = sigm((pb[3 * RS + q] + z[3]) + bs[3 * Sz + jl]);
          const float c = gf * cb[q] + gi * gg;
          h = go * tanhf(c);
          cb[q] = c;
          const size_t yo = ((size_t)t * N + n) * H + j;
          ys[yo] = h;
          if (SAVE) {
            const size_t xo = ((size_t)t * 4 * N + n) * H + j;
            cs[yo] = c;
            gates[xo] = gi;
            gates[xo + NH] = gf;
            gates[xo + 2 * NH] = gg;
            gates[xo + 3 * NH] = go;
          }
        }
        // lane s stores the group's new h into CTA s of the cluster
        float* peer = cluster.map_shared_rank(hx, s);
        const int base = lane & ~(FG - 1);
        const int ho = ((buf ^ 1) * R + nb) * H + j0 + jl;
#pragma unroll
        for (int r = 0; r < FR; ++r) {
          const float v = __shfl_sync(group, h, base + r);
          if (r < nrow) peer[ho + r * H] = v;
        }
      }
      if (t + 1 < T)
        fwd_prefetch(pre + (buf ^ 1) * 4 * RS, xp, t + 1, n0, rows, j0, sz,
                     N, H, RS, Sz);
      cp_async_commit();
      cluster.sync();  // h of step t from every CTA is here
    }
    const float* hl = hx + (step & 1) * R * H;
    for (int e = threadIdx.x; e < rows * sz; e += BT) {
      const int r = e / sz, jl = e - r * sz;
      const size_t dst = (size_t)(n0 + r) * H + j0 + jl;
      hT[dst] = hl[r * H + j0 + jl];
      cT[dst] = cb[r * Sz + jl];
    }
  }
}

// -- K6 ----------------------------------------------------------------------
// Floats of a K6 CTA's shared memory besides its rows of w4: the dz
// exchange [2][R][4][H], dh and dc [R][Sz], the prefetch [2][7][R][Sz].
inline size_t bwd_fixed_floats(int R, int H, int Sz) {
  return (size_t)8 * R * H + (size_t)16 * R * Sz;
}

// The step-t inputs of this thread's elements (r, jl) -> pre[7][R][Sz]:
// gates i, f, g, o, c, c_prev, dy.
__device__ __forceinline__ void bwd_prefetch(
    float* pre, const float* __restrict__ gates, const float* __restrict__ cs,
    const float* __restrict__ c0, const float* __restrict__ dys, int t,
    int n0, int rows, int j0, int sz, int N, int H, int RS, int Sz) {
  const size_t NH = (size_t)N * H;
  for (int e = threadIdx.x; e < rows * sz; e += BT) {
    const int r = e / sz, jl = e - r * sz;
    const int n = n0 + r, j = j0 + jl;
    const int q = r * Sz + jl;
    const size_t xo = ((size_t)t * 4 * N + n) * H + j;
    const size_t yo = ((size_t)t * N + n) * H + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async4(pre + k * RS + q, gates + xo + k * NH);
    cp_async4(pre + 4 * RS + q, cs + yo);
    cp_async4(pre + 5 * RS + q, t > 0 ? cs + yo - NH : c0 + (size_t)n * H + j);
    cp_async4(pre + 6 * RS + q, dys + yo);
  }
}

// dhs[n][il] = sum_k sum_j dzb[n][k][j] * w4s[il][k][j] for il < sw,
// n < rows (rows of w4 in shared memory).  The product is bound by
// shared-memory reads, so a group of DG threads takes two rows il and two
// batch rows n at a time: each float4 of w4 feeds two batch rows and each
// float4 of dz two rows il.  Each thread takes a DG-th of the 4H
// products, then four shuffles sum the group in a fixed order.
constexpr int DG = 16;
__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

__device__ __forceinline__ void dh_local(float* dhs, const float* dzb,
                                         const float* w4s, int rows, int sw,
                                         int H, int Sz) {
  const int lane = threadIdx.x & 31;
  const unsigned group = 0xFFFFu << (lane & DG);
  const int s = threadIdx.x % DG;
  const int chunk = (H + DG - 1) / DG;  // float4s of the 4H per thread
  const int q0 = s * chunk, q1 = min(H, q0 + chunk);
  for (int g = threadIdx.x / DG; 2 * g < sw; g += BT / DG) {
    const int il0 = 2 * g, il1 = min(il0 + 1, sw - 1);  // a last lone row
    const float4* w0 = reinterpret_cast<const float4*>(w4s + il0 * 4 * H);
    const float4* w1 = reinterpret_cast<const float4*>(w4s + il1 * 4 * H);
    for (int n0 = 0; n0 < rows; n0 += 2) {
      const int n1 = min(n0 + 1, rows - 1);  // pairs with itself
      const float4* z0 = reinterpret_cast<const float4*>(dzb + n0 * 4 * H);
      const float4* z1 = reinterpret_cast<const float4*>(dzb + n1 * 4 * H);
      float4 a00 = make_float4(0.f, 0.f, 0.f, 0.f), a01 = a00, a10 = a00,
             a11 = a00;  // a[il][n]
#pragma unroll 4
      for (int q = q0; q < q1; ++q) {
        const float4 x0 = w0[q], x1 = w1[q], y0 = z0[q], y1 = z1[q];
        a00 = fma4(x0, y0, a00);
        a01 = fma4(x0, y1, a01);
        a10 = fma4(x1, y0, a10);
        a11 = fma4(x1, y1, a11);
      }
      float v[4] = {(a00.x + a00.y) + (a00.z + a00.w),
                    (a01.x + a01.y) + (a01.z + a01.w),
                    (a10.x + a10.y) + (a10.z + a10.w),
                    (a11.x + a11.y) + (a11.z + a11.w)};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int off = DG / 2; off > 0; off >>= 1)
          v[u] += __shfl_xor_sync(group, v[u], off);
      if (s == 0) {
        dhs[n0 * Sz + il0] = v[0];
        dhs[n1 * Sz + il0] = v[1];
        dhs[n0 * Sz + il1] = v[2];
        dhs[n1 * Sz + il1] = v[3];
      }
    }
  }
}

// The same for il in [il0, il1), rows of w4 read from device memory (L2),
// where a CTA's slice of w4 does not fit its shared memory: a warp takes
// IL rows il at a time (il0 + warp + 8m), its lanes run along j, each dz
// value feeds IL x RB accumulators, and a fixed shuffle tree sums each
// (n, il) over the lanes.
constexpr int IL = 4;
__device__ __forceinline__ void dh_stream(float* dhs, const float* dzb,
                                          const float* __restrict__ w4,
                                          int il0, int il1, int rows, int H,
                                          int Sz, int j0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WARPS = BT / 32;
  for (int p0 = il0 + warp; p0 < il1; p0 += WARPS * IL) {
    int ils[IL];
#pragma unroll
    for (int m = 0; m < IL; ++m) {
      const int il = p0 + WARPS * m;
      ils[m] = il < il1 ? il : p0;  // a row past the slice reads row p0
    }
    for (int nb = 0; nb < rows; nb += RB) {
      float acc[IL][RB];
#pragma unroll
      for (int m = 0; m < IL; ++m)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[m][r] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* wr[IL];
#pragma unroll
        for (int m = 0; m < IL; ++m)
          wr[m] = w4 + ((size_t)k * H + j0 + ils[m]) * H;
        const float* zr = dzb + (nb * 4 + k) * H;
#pragma unroll 2
        for (int j = lane; j < H; j += 32) {
          float wv[IL];
#pragma unroll
          for (int m = 0; m < IL; ++m) wv[m] = __ldg(wr[m] + j);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (nb + r < rows) {
              const float z = zr[r * 4 * H + j];
#pragma unroll
              for (int m = 0; m < IL; ++m) acc[m][r] = fmaf(z, wv[m], acc[m][r]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < IL; ++m)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float v = acc[m][r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0 && nb + r < rows && p0 + WARPS * m < il1)
            dhs[(nb + r) * Sz + ils[m]] = v;
        }
    }
  }
}

// K6's recurrence: clusters of CL CTAs, CTA `rank` owning the H indices
// [rank*Sz, rank*Sz + sz); R batch rows per cluster pass, Sw of the
// slice's w4 rows in shared memory.
__global__ void __launch_bounds__(BT)
    lstm_bwd_cluster_kernel(const float* __restrict__ gates,
                            const float* __restrict__ cs,
                            const float* __restrict__ w4,
                            const float* __restrict__ c0,
                            const float* __restrict__ dys,
                            const float* __restrict__ dhT,
                            const float* __restrict__ dcT,
                            float* __restrict__ dxp, float* __restrict__ dh0,
                            float* __restrict__ dc0, int T, int N, int H,
                            int R, int Sz, int Sw) {
  extern __shared__ float4 sm4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int nclusters = gridDim.x / CL;
  const int j0 = rank * Sz;
  const int sz = max(0, min(Sz, H - j0));
  const int sw = min(Sw, sz);
  const int RS = R * Sz;
  float* dzx = reinterpret_cast<float*>(sm4);  // [2][R][4][H]
  float* w4s = dzx + 8 * R * H;                // [Sw][4][H]
  float* dhs = w4s + Sw * 4 * H;               // [R][Sz]
  float* dcs = dhs + RS;                       // [R][Sz]
  float* pre = dcs + RS;                       // [2][7][R][Sz]
  const size_t NH = (size_t)N * H;
  // four threads per element (n, j) of the slice, each storing its dz
  // into two CTAs of the cluster
  const int part = threadIdx.x & 3;
  const unsigned quad = 0xFu << ((threadIdx.x & 31) & ~3);

  for (int idx = threadIdx.x; idx < 4 * sw * H; idx += BT) {
    const int il = idx / (4 * H);
    const int rem = idx - il * 4 * H;
    const int k = rem / H, j = rem - k * H;
    w4s[(il * 4 + k) * H + j] = w4[((size_t)k * H + j0 + il) * H + j];
  }
  cluster.sync();  // every CTA of the cluster runs, w4s is loaded

  const int ngroups = (N + R - 1) / R;
  int step = 0;  // counts steps across row groups: the buffer parity
  for (int grp = cid; grp < ngroups; grp += nclusters) {
    const int n0 = grp * R;
    const int rows = min(R, N - n0);
    for (int e = threadIdx.x; e < rows * sz; e += BT) {
      const int r = e / sz, jl = e - r * sz;
      const size_t src = (size_t)(n0 + r) * H + j0 + jl;
      dhs[r * Sz + jl] = dhT[src];
      dcs[r * Sz + jl] = dcT[src];
    }
    bwd_prefetch(pre + (step & 1) * 7 * RS, gates, cs, c0, dys, T - 1, n0,
                 rows, j0, sz, N, H, RS, Sz);
    cp_async_commit();
    for (int t = T - 1; t >= 0; --t, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();  // step t's inputs are in pre, dh of step t in dhs
      const float* pb = pre + buf * 7 * RS;
      for (int e = threadIdx.x / 4; e < rows * sz; e += BT / 4) {
        const int r = e / sz, jl = e - r * sz;
        const int n = n0 + r, j = j0 + jl;
        const int q = r * Sz + jl;
        const float gi = pb[q], gf = pb[RS + q], gg = pb[2 * RS + q];
        const float go = pb[3 * RS + q], c = pb[4 * RS + q];
        const float c_prev = pb[5 * RS + q];
        const float dh = dhs[q] + pb[6 * RS + q];
        const float tc = tanhf(c);
        const float dout = dh * tc;
        const float dc = dcs[q] + dh * go * (1.0f - tc * tc);
        float dz[4];
        dz[0] = dc * gg * gi * (1.0f - gi);
        dz[1] = dc * c_prev * gf * (1.0f - gf);
        dz[2] = dc * gi * (1.0f - gg * gg);
        dz[3] = dout * go * (1.0f - go);
        const int zo = ((buf * R + r) * 4) * H + j;
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          float* peer = cluster.map_shared_rank(dzx, 2 * part + c2);
#pragma unroll
          for (int k = 0; k < 4; ++k) peer[zo + k * H] = dz[k];
        }
        __syncwarp(quad);  // the four have read dcs[q]
        if (part == 0) {
          const size_t xo = ((size_t)t * 4 * N + n) * H + j;
#pragma unroll
          for (int k = 0; k < 4; ++k) dxp[xo + k * NH] = dz[k];
          dcs[q] = dc * gf;
        }
      }
      if (t > 0)
        bwd_prefetch(pre + (buf ^ 1) * 7 * RS, gates, cs, c0, dys, t - 1, n0,
                     rows, j0, sz, N, H, RS, Sz);
      cp_async_commit();
      cluster.sync();  // dz of step t from every CTA is here

      // dh_prev[n][i] = sum_k sum_j dz[n][k][j] * w4[k][i][j], i in slice
      const float* dzb = dzx + buf * R * 4 * H;
      dh_local(dhs, dzb, w4s, rows, sw, H, Sz);
      dh_stream(dhs, dzb, w4, sw, sz, rows, H, Sz, j0);
    }
    __syncthreads();  // dh0 of the group is in dhs
    for (int e = threadIdx.x; e < rows * sz; e += BT) {
      const int r = e / sz, jl = e - r * sz;
      const size_t dst = (size_t)(n0 + r) * H + j0 + jl;
      dh0[dst] = dhs[r * Sz + jl];
      dc0[dst] = dcs[r * Sz + jl];
    }
  }
}

// The T*N axis of the dw4 product is cut into this many chunks.
inline int dw_splits(long long TN, int H) {
  const long long tiles = (long long)((H + DWT - 1) / DWT) *
                          ((H + 1 + DWT - 1) / DWT) * 4;
  long long P = (DW_BLOCKS + tiles - 1) / tiles;
  const long long most = (TN + 63) / 64;  // at least 64 values a chunk
  if (P > most) P = most;
  return P < 1 ? 1 : (int)P;
}

// dw4[k][i][j] = sum_{t,n} h_prev[t][n][i] * dxp[t][k][n][j] and, as the
// extra row i = H (h_prev taken as 1), dbh[k][j] = sum_{t,n} dxp[t][k][n][j].
// h_prev[t] is ys[t-1], and h0 at t = 0.  Grid: (j tiles, i tiles over
// H + 1 rows, 4 gates x P chunks); chunk p sums rows [p*chunk, ...) of
// the T*N axis in order, into dw4/dbh when P = 1, else into part[p].
__global__ void __launch_bounds__(DW_THREADS)
    lstm_dw_kernel(const float* __restrict__ ys, const float* __restrict__ h0,
                   const float* __restrict__ dxp, float* __restrict__ dw4,
                   float* __restrict__ dbh, float* __restrict__ part, int T,
                   int N, int H, int chunk, int P) {
  __shared__ __align__(16) float As[DWK][DWT];
  __shared__ __align__(16) float Bs[DWK][DWT];
  const int k = blockIdx.z & 3, p = blockIdx.z >> 2;
  const int i0 = blockIdx.y * DWT, j0 = blockIdx.x * DWT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // T*4*N*H < 2^31 (mxtt_lstm_work_floats), so 32-bit offsets suffice
  const int TN = T * N;
  const int rb0 = p * chunk;
  const int rend = min(TN, rb0 + chunk);
  const int NH = N * H;
  constexpr int PER = DWK * DWT / DW_THREADS;  // values each thread stages

  float a_n[PER], b_n[PER];
  auto fetch = [&](int rb) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = threadIdx.x + u * DW_THREADS;
      const int kl = idx / DWT, c = idx - kl * DWT;
      const int r = rb + kl;
      float a = 0.f, b = 0.f;
      if (r < rend) {
        const int i = i0 + c, j = j0 + c;
        if (i < H)
          a = r < N ? h0[r * H + i] : ys[(r - N) * H + i];
        else if (i == H)
          a = 1.0f;
        if (j < H) {
          const int tt = r / N, n = r - tt * N;
          b = dxp[(tt * 4 + k) * NH + n * H + j];
        }
      }
      a_n[u] = a;
      b_n[u] = b;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  if (rb0 < rend) fetch(rb0);
  for (int rb = rb0; rb < rend; rb += DWK) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = threadIdx.x + u * DW_THREADS;
      const int kl = idx / DWT, c = idx - kl * DWT;
      As[kl][c] = a_n[u];
      Bs[kl][c] = b_n[u];
    }
    __syncthreads();
    if (rb + DWK < rend) fetch(rb + DWK);  // the next stage, in flight
#pragma unroll
    for (int kl = 0; kl < DWK; ++kl) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kl][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kl][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i > H) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (j >= H) break;
      if (P > 1)
        part[(((size_t)p * 4 + k) * (H + 1) + i) * H + j] = acc[a][b];
      else if (i < H)
        dw4[((size_t)k * H + i) * H + j] = acc[a][b];
      else
        dbh[(size_t)k * H + j] = acc[a][b];
    }
  }
}

// dw4/dbh = the P partial products summed in chunk order.
__global__ void lstm_dw_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dw4,
                                      float* __restrict__ dbh, int H, int P) {
  const size_t per_gate = (size_t)(H + 1) * H;
  const size_t per = 4 * per_gate;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < per;
       o += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[p * per + o];
    const size_t k = o / per_gate, rem = o - k * per_gate;
    const size_t i = rem / H, j = rem - i * H;
    if (i < (size_t)H)
      dw4[(k * H + i) * H + j] = s;
    else
      dbh[k * H + j] = s;
  }
}

// How a clustered recurrence is laid out for (N, H) on the current device:
// rows per cluster pass, slice width, rows i of the slice of w4 kept in
// shared memory, clusters, shared memory bytes per CTA; for K4/K5 also
// the pitch of w4s and the i chunk of a lane.  Cached per (device, N, H).
struct Plan {
  int dev = -1, N = 0, H = 0;
  int R = 0, Sz = 0, Sw = 0, clusters = 0;
  size_t smem = 0;
  int P = 0, chunk = 0;
};

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int clusters, size_t smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * CL);
  cfg->blockDim = dim3(BT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The fewest rows per cluster (at most R_max) whose row groups all run at
// once, for a CTA that needs bytes(R) of shared memory and runs kernel(R);
// with it, the clusters the card holds at once.
template <typename Bytes, typename Kernel>
int pick_rows(int N, int R_max, Bytes bytes, Kernel kernel, int* R_out,
              int* active_out) {
  if (R_max < 1) return (int)cudaErrorInvalidValue;
  int R = 1, active = 0;
  for (int tries = 0; tries < 4; ++tries) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, 1, bytes(R), 0);
    const int err = (int)cudaOccupancyMaxActiveClusters(&active, kernel(R),
                                                        &cfg);
    if (err) return err;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    if ((N + R - 1) / R <= active || R == R_max) break;
    R = (N + active - 1) / active;
    if (R > R_max) R = R_max;
  }
  *R_out = R;
  *active_out = active;
  return 0;
}

// Looks up (dev, N, H) in `cached`, else fills it with make(plan) under `mu`.
template <typename Make>
int cached_plan(std::mutex& mu, Plan& cached, int N, int H, Plan* plan,
                Make make) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (cached.dev != dev || cached.N != N || cached.H != H) {
    Plan fresh;
    err = make(&fresh);
    if (err) return err;
    fresh.dev = dev;
    fresh.N = N;
    fresh.H = H;
    cached = fresh;
  }
  *plan = cached;
  return 0;
}

int fwd_plan(int N, int H, Plan* plan) {
  static std::mutex mu;
  static Plan cached;
  return cached_plan(mu, cached, N, H, plan, [&](Plan* p) {
    const void* kernels[] = {(const void*)lstm_fwd_cluster_kernel<false>,
                             (const void*)lstm_fwd_cluster_kernel<true>};
    for (const void* k : kernels) {
      const int err = (int)cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (err) return err;
    }
    const int Sz = (H + CL - 1) / CL;
    const int P = Sz | 1;  // odd pitches and chunks: no bank conflicts
    const int chunk = ((H + FG - 1) / FG) | 1;
    const size_t limit = SMEM_LIMIT / sizeof(float);
    const size_t ldw = 4 * (size_t)P;  // floats of one row i of w4s
    auto w4_rows = [&](int R) {  // rows of the slice that fit beside the rest
      const size_t fixed = fwd_fixed_floats(R, H, Sz);
      const size_t rows = fixed < limit ? (limit - fixed) / ldw : 0;
      return (int)(rows < (size_t)H ? rows : H);
    };
    auto bytes = [&](int R) {
      return (fwd_fixed_floats(R, H, Sz) + (size_t)w4_rows(R) * ldw) *
             sizeof(float);
    };
    const int R_max = (int)((limit - 4 * (size_t)Sz) /
                            (2 * (size_t)H + 9 * (size_t)Sz));
    int R = 0, active = 0;
    const int err = pick_rows(
        N, R_max, bytes,
        [](int) { return (const void*)lstm_fwd_cluster_kernel<true>; }, &R,
        &active);
    if (err) return err;
    const int groups = (N + R - 1) / R;
    p->R = R;
    p->Sz = Sz;
    p->Sw = w4_rows(R);
    p->clusters = groups < active ? groups : active;
    p->smem = bytes(R);
    p->P = P;
    p->chunk = chunk;
    return 0;
  });
}

int bwd_plan(int N, int H, Plan* plan) {
  static std::mutex mu;
  static Plan cached;
  return cached_plan(mu, cached, N, H, plan, [&](Plan* p) {
    int err = (int)cudaFuncSetAttribute(
        lstm_bwd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err) return err;
    const int Sz = (H + CL - 1) / CL;
    const size_t limit = SMEM_LIMIT / sizeof(float);
    const size_t ldw = 4 * (size_t)H;  // floats of one row i of w4s
    auto w4_rows = [&](int R) {  // rows of the slice that fit beside the rest
      const size_t fixed = bwd_fixed_floats(R, H, Sz);
      const size_t rows = fixed < limit ? (limit - fixed) / ldw : 0;
      return (int)(rows < (size_t)Sz ? rows : Sz);
    };
    auto bytes = [&](int R) {
      return (bwd_fixed_floats(R, H, Sz) + (size_t)w4_rows(R) * ldw) *
             sizeof(float);
    };
    const int R_max = (int)(limit / (8 * (size_t)H + 16 * (size_t)Sz));
    int R = 0, active = 0;
    err = pick_rows(
        N, R_max, bytes,
        [](int) { return (const void*)lstm_bwd_cluster_kernel; }, &R,
        &active);
    if (err) return err;
    const int groups = (N + R - 1) / R;
    p->R = R;
    p->Sz = Sz;
    p->Sw = w4_rows(R);
    p->clusters = groups < active ? groups : active;
    p->smem = bytes(R);
    return 0;
  });
}

// out = {rows per cluster pass, slice width, rows of a slice of w4 in
// shared memory, clusters, shared memory bytes per CTA}.
int plan_out(int err, const Plan& plan, long long* out) {
  if (err) return err;
  out[0] = plan.R;
  out[1] = plan.Sz;
  out[2] = plan.Sw;
  out[3] = plan.clusters;
  out[4] = (long long)plan.smem;
  return 0;
}

template <bool SAVE>
int fwd_launch(const float* xp, const float* w4, const float* bh,
               const float* h0, const float* c0, float* ys, float* gates,
               float* cs, float* hT, float* cT, int T, int N, int H,
               void* stream) {
  Plan plan;
  int err = fwd_plan(N, H, &plan);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, plan.clusters, plan.smem,
                 (cudaStream_t)stream);
  err = (int)cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<SAVE>, xp, w4,
                                bh, h0, c0, ys, gates, cs, hT, cT, T, N, H,
                                plan.R, plan.Sz, plan.P, plan.Sw, plan.chunk);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of work space one call needs (K6: the partial dw4/dbh products,
// P * 4 * (H+1) * H when the T*N axis is split; K4 and K5: none), or -1
// for a shape the kernels do not take: H above MAX_H or T*4*N*H at or
// above 2^31.  The wrappers size their allocation from this, so the limits
// live here only.
extern "C" long long mxtt_lstm_work_floats(long long T, long long N,
                                           long long H, int bwd) {
  if (T <= 0 || N <= 0 || H <= 0 || H > MAX_H) return -1;
  if (T * 4 * N * H >= (1LL << 31)) return -1;
  if (!bwd) return 0;
  const int P = dw_splits(T * N, (int)H);
  return P > 1 ? (long long)P * 4 * (H + 1) * H : 0;
}

// The layouts of K4/K5 and of K6's recurrence for (N, H) on the current
// device, for reports: out = {rows per cluster pass, slice width, rows of
// a slice of w4 in shared memory, clusters, shared memory bytes per CTA}.
// Each returns a CUDA error.
extern "C" int mxtt_lstm_fwd_plan(int N, int H, long long* out) {
  Plan plan;
  return plan_out(fwd_plan(N, H, &plan), plan, out);
}

extern "C" int mxtt_lstm_bwd_plan(int N, int H, long long* out) {
  Plan plan;
  return plan_out(bwd_plan(N, H, &plan), plan, out);
}

// Each entry point launches on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 when every launch was taken).
extern "C" int mxtt_lstm_infer(const float* xp, const float* w4,
                               const float* bh, const float* h0,
                               const float* c0, float* ys, float* hT,
                               float* cT, int T, int N, int H, void* stream) {
  return fwd_launch<false>(xp, w4, bh, h0, c0, ys, nullptr, nullptr, hT, cT,
                           T, N, H, stream);
}

extern "C" int mxtt_lstm_fwd(const float* xp, const float* w4,
                             const float* bh, const float* h0,
                             const float* c0, float* ys, float* gates,
                             float* cs, float* hT, float* cT, int T, int N,
                             int H, void* stream) {
  return fwd_launch<true>(xp, w4, bh, h0, c0, ys, gates, cs, hT, cT, T, N, H,
                          stream);
}

extern "C" int mxtt_lstm_bwd(const float* gates, const float* cs,
                             const float* ys, const float* w4,
                             const float* h0, const float* c0,
                             const float* dys, const float* dhT,
                             const float* dcT, float* dxp, float* dw4,
                             float* dbh, float* dh0, float* dc0, float* work,
                             int T, int N, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Plan plan;
  int err = bwd_plan(N, H, &plan);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, plan.clusters, plan.smem, st);
  err = (int)cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel, gates, cs, w4,
                                c0, dys, dhT, dcT, dxp, dh0, dc0, T, N, H,
                                plan.R, plan.Sz, plan.Sw);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long TN = (long long)T * N;
  const int P = dw_splits(TN, H);
  int chunk = (int)((TN + P - 1) / P);
  chunk = (chunk + DWK - 1) / DWK * DWK;
  const dim3 grid((H + DWT - 1) / DWT, (H + 1 + DWT - 1) / DWT, 4 * P);
  lstm_dw_kernel<<<grid, DW_THREADS, 0, st>>>(ys, h0, dxp, dw4, dbh, work, T,
                                              N, H, chunk, P);
  err = (int)cudaGetLastError();
  if (err || P == 1) return err;
  const long long per = 4LL * (H + 1) * H;
  const long long blocks = (per + 255) / 256;
  lstm_dw_reduce_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
      work, dw4, dbh, H, P);
  return (int)cudaGetLastError();
}
