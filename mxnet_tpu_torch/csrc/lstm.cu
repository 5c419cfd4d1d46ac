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
// K4 and K5 (simple first; the cluster design of K6 is their next step):
//   * w4 (640 KB at H = 200) does not fit a block's 227 KB of shared
//     memory, but batch rows of an LSTM never interact.  So one block owns
//     ROWS whole batch rows for the whole sequence (grid = N / ROWS
//     blocks, no communication between blocks).  Its h and c live in
//     shared memory (h double-buffered, one __syncthreads per step), and
//     w4 streams from L2 every step (it fits the 50 MB L2 many times).
//   * Thread j owns output column j of every gate and every row of the
//     block, so the four gates of (row, j) meet in its registers and the
//     cell update needs no exchange.  w4[k][i][j] is read along j by
//     neighbouring threads (coalesced); h[r][i] is a shared-memory
//     broadcast.  H = 200 is ragged for warps: blockDim is H rounded up
//     to 32, threads past H idle.
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

constexpr int ROWS = 2;       // batch rows one K4/K5 block owns
constexpr int MAX_H = 1024;   // K4/K5: one thread per column, at most 1024
constexpr int CL = 8;         // CTAs per K6 cluster (the portable maximum)
constexpr int BT = 256;       // threads per K6 CTA
constexpr int RB = 4;         // batch rows per register block of dh
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use
constexpr int DWT = 64;       // dw4 output tile (DWT x DWT)
constexpr int DWK = 32;       // T*N values per stage of the dw4 product
constexpr int DW_THREADS = 256;
constexpr int DW_BLOCKS = 528;  // about four blocks per SM of a 132-SM card

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

inline int threads_for(int H) {
  return ((H + 31) / 32) * 32;
}

// K4 (SAVE = false) and K5 (SAVE = true).  Shared memory: h[2][ROWS][H],
// c[ROWS][H].
template <bool SAVE>
__global__ void lstm_fwd_kernel(const float* __restrict__ xp,
                                const float* __restrict__ w4,
                                const float* __restrict__ bh,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                float* __restrict__ ys,
                                float* __restrict__ gates,
                                float* __restrict__ cs,
                                float* __restrict__ hT,
                                float* __restrict__ cT, int T, int N,
                                int H) {
  extern __shared__ float sm[];
  float* hbuf = sm;                 // [2][ROWS][H]
  float* cbuf = sm + 2 * ROWS * H;  // [ROWS][H]
  const int n0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, N - n0);
  const size_t HH = (size_t)H * H;
  const size_t NH = (size_t)N * H;
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    const int r = idx / H;
    const size_t src = (size_t)(n0 + r) * H + (idx - r * H);
    hbuf[idx] = r < rows ? h0[src] : 0.f;
    hbuf[ROWS * H + idx] = 0.f;
    cbuf[idx] = r < rows ? c0[src] : 0.f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf + (t & 1) * ROWS * H;
    float* hn = hbuf + ((t + 1) & 1) * ROWS * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[4][ROWS];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[k][r] = 0.f;
      const float* w = w4 + j;
#pragma unroll 4
      for (int i = 0; i < H; ++i) {
        const size_t o = (size_t)i * H;
        const float w0 = __ldg(w + o);
        const float w1 = __ldg(w + HH + o);
        const float w2 = __ldg(w + 2 * HH + o);
        const float w3 = __ldg(w + 3 * HH + o);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float hv = hc[r * H + i];
          acc[0][r] = fmaf(hv, w0, acc[0][r]);
          acc[1][r] = fmaf(hv, w1, acc[1][r]);
          acc[2][r] = fmaf(hv, w2, acc[2][r]);
          acc[3][r] = fmaf(hv, w3, acc[3][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        const int n = n0 + r;
        const size_t xo = ((size_t)t * 4 * N + n) * H + j;  // xp[t][0][n][j]
        const float gi = sigm((xp[xo] + acc[0][r]) + bh[j]);
        const float gf = sigm((xp[xo + NH] + acc[1][r]) + bh[H + j]);
        const float gg = tanhf((xp[xo + 2 * NH] + acc[2][r]) + bh[2 * H + j]);
        const float go = sigm((xp[xo + 3 * NH] + acc[3][r]) + bh[3 * H + j]);
        const float c = gf * cbuf[r * H + j] + gi * gg;
        const float h = go * tanhf(c);
        cbuf[r * H + j] = c;
        hn[r * H + j] = h;
        const size_t yo = ((size_t)t * N + n) * H + j;
        ys[yo] = h;
        if (SAVE) {
          cs[yo] = c;
          gates[xo] = gi;
          gates[xo + NH] = gf;
          gates[xo + 2 * NH] = gg;
          gates[xo + 3 * NH] = go;
        }
      }
    }
    __syncthreads();
  }
  const float* hl = hbuf + (T & 1) * ROWS * H;
  for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x) {
    const size_t dst = (size_t)n0 * H + idx;
    hT[dst] = hl[idx];
    cT[dst] = cbuf[idx];
  }
}

// -- K6 ----------------------------------------------------------------------
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

// How K6's recurrence is laid out for (N, H) on the current device: rows
// per cluster pass, slice width, w4 rows kept in shared memory, clusters,
// shared memory bytes.  Cached per (device, N, H).
struct BwdPlan {
  int dev = -1, N = 0, H = 0;
  int R = 0, Sz = 0, Sw = 0, clusters = 0;
  size_t smem = 0;
};

int active_clusters(size_t smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, lstm_bwd_cluster_kernel,
                                             &cfg);
}

int bwd_plan(int N, int H, BwdPlan* plan) {
  static std::mutex mu;
  static BwdPlan cached;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (cached.dev == dev && cached.N == N && cached.H == H) {
    *plan = cached;
    return 0;
  }
  err = (int)cudaFuncSetAttribute(lstm_bwd_cluster_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  if (R_max < 1) return (int)cudaErrorInvalidValue;
  // the fewest rows per cluster whose row groups all run at once
  int R = 1, active = 0;
  for (int tries = 0; tries < 4; ++tries) {
    err = active_clusters(bytes(R), &active);
    if (err) return err;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    if ((N + R - 1) / R <= active || R == R_max) break;
    R = (N + active - 1) / active;
    if (R > R_max) R = R_max;
  }
  const int groups = (N + R - 1) / R;
  cached.dev = dev;
  cached.N = N;
  cached.H = H;
  cached.R = R;
  cached.Sz = Sz;
  cached.Sw = w4_rows(R);
  cached.clusters = groups < active ? groups : active;
  cached.smem = bytes(R);
  *plan = cached;
  return 0;
}

}  // namespace

// Floats of work space one call needs (K6: the partial dw4/dbh products,
// P * 4 * (H+1) * H when the T*N axis is split; K4 and K5: none), or -1
// for a shape the kernels do not take: H above MAX_H (K4/K5 give a thread
// to each column) or T*4*N*H at or above 2^31.  The wrappers size their
// allocation from this, so the limits live here only.
extern "C" long long mxtt_lstm_work_floats(long long T, long long N,
                                           long long H, int bwd) {
  if (T <= 0 || N <= 0 || H <= 0 || H > MAX_H) return -1;
  if (T * 4 * N * H >= (1LL << 31)) return -1;
  if (!bwd) return 0;
  const int P = dw_splits(T * N, (int)H);
  return P > 1 ? (long long)P * 4 * (H + 1) * H : 0;
}

// K6's layout for (N, H) on the current device, for reports:
// out = {rows per cluster pass, slice width, w4 rows of a slice in shared
// memory, clusters, shared memory bytes per CTA}.  Returns a CUDA error.
extern "C" int mxtt_lstm_bwd_plan(int N, int H, long long* out) {
  BwdPlan plan;
  const int err = bwd_plan(N, H, &plan);
  if (err) return err;
  out[0] = plan.R;
  out[1] = plan.Sz;
  out[2] = plan.Sw;
  out[3] = plan.clusters;
  out[4] = (long long)plan.smem;
  return 0;
}

// Each entry point launches on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 when every launch was taken).
extern "C" int mxtt_lstm_infer(const float* xp, const float* w4,
                               const float* bh, const float* h0,
                               const float* c0, float* ys, float* hT,
                               float* cT, int T, int N, int H, void* stream) {
  const size_t smem = (size_t)3 * ROWS * H * sizeof(float);
  lstm_fwd_kernel<false><<<(N + ROWS - 1) / ROWS, threads_for(H), smem,
                           (cudaStream_t)stream>>>(
      xp, w4, bh, h0, c0, ys, nullptr, nullptr, hT, cT, T, N, H);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_lstm_fwd(const float* xp, const float* w4,
                             const float* bh, const float* h0,
                             const float* c0, float* ys, float* gates,
                             float* cs, float* hT, float* cT, int T, int N,
                             int H, void* stream) {
  const size_t smem = (size_t)3 * ROWS * H * sizeof(float);
  lstm_fwd_kernel<true><<<(N + ROWS - 1) / ROWS, threads_for(H), smem,
                          (cudaStream_t)stream>>>(
      xp, w4, bh, h0, c0, ys, gates, cs, hT, cT, T, N, H);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_lstm_bwd(const float* gates, const float* cs,
                             const float* ys, const float* w4,
                             const float* h0, const float* c0,
                             const float* dys, const float* dhT,
                             const float* dcT, float* dxp, float* dw4,
                             float* dbh, float* dh0, float* dc0, float* work,
                             int T, int N, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  BwdPlan plan;
  int err = bwd_plan(N, H, &plan);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(plan.clusters * CL);
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
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
