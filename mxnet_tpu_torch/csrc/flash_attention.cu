// Flash attention for Hopper (sm_90a), f32 in and out, on the tensor
// cores at f32 accuracy (3xTF32): the forward K3 (first) and the backward
// K3b (below it).
//
// Replaces mxnet_tpu/ops/attention.py::_fa_kernel (reached through
// _flash_pallas).  It computes the same function, not the same blocks:
//
//   out = softmax(scale * Q K^T  [causal: qi >= ki, top-left aligned]) V
//   lse = m + log(max(l, 1e-30))            (B, H, Lq) f32
//
// with masked scores set to -1e30 and the running sum l clamped at 1e-30,
// so fully masked rows behave as in the JAX code.  Ragged Lq and Lk are
// masked inside the kernel.  D <= 128.
//
// What bounds it: at the served shape (L = 2048, D = 128) the two products
// are 4*L*L*D operations per (batch, head), about 16 per byte read, so the
// kernel is bound by operations.  On the CUDA cores (67 TFLOP/s f32) that
// is 0.51 ms at B = 4, causal; the tensor cores do TF32 at 495 TFLOP/s.
// One TF32 pass rounds each operand to 11 significant bits, which leaves
// score errors near 5e-4 at D = 128, above the 1e-4 the kernel is held
// to.  So every product is taken as three TF32 products summed in f32
// (3xTF32, as PyTorch's f32 memory-efficient attention does):
//
//   a*b ~ a_big*b_small + a_small*b_big + a_big*b_big,
//   x_big = tf32_rna(x),  x_small = tf32_rz(x - x_big),
//
// which keeps about 22 significant bits: the bound for the same
// f32-accurate work is 3 * 4*L*L*D / 495 TFLOP/s.
//
// Design (mma.sync.m16n8k8.tf32, the instruction of that yardstick; the
// split happens in registers from one f32 copy in shared memory):
//   * one CTA of 8 warps per (batch*head, 128-row Q tile); each warp owns
//     16 query rows.  The grid is one dimension with the heaviest causal
//     Q tiles of every head launched first;
//   * K and V tiles of 64 keys arrive by cp.async (16-byte copies where
//     rows are 16-byte aligned and D % 4 == 0, 4-byte copies otherwise,
//     zero-filled past Lk and D) into a ring of two stages, so the copy
//     of tile t+1 overlaps the products of tile t;
//   * rows in shared memory are padded to 132 floats, so every fragment
//     load below hits 32 distinct banks;
//   * S = Q K^T for the warp's 16 x 64 block stays in registers (the C
//     fragments); masking and the online softmax (m, l) run there, rows
//     reduced across the 4 lanes that share them;
//   * P feeds P V without a trip through shared memory: the C fragment
//     holds keys 2t and 2t+1 of each row where the A fragment wants keys
//     t and t+4, so the kernel renumbers the keys of each 8-key step
//     (A column t <-> key 2t, column t+4 <-> key 2t+1) and reads the
//     matching V rows for the B fragment;
//   * K tiles wholly above the diagonal are never loaded (causal skip);
//     a warp whose rows all lie above a tile skips its products.
// Shared memory: Q 128x132 + 2 stages of K and V 64x132, 198 KB, as
// dynamic shared memory (one CTA per SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 64;         // keys per stage
constexpr int DMAX = 128;      // largest head dim
constexpr int LD = DMAX + 4;   // padded row stride in shared memory
constexpr int NWARP = BQ / 16;
constexpr int NT = NWARP * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)
constexpr int Q_FLOATS = BQ * LD;
constexpr int KV_FLOATS = BK * LD;
constexpr size_t SMEM_BYTES =
    (size_t)(Q_FLOATS + 4 * KV_FLOATS) * sizeof(float);

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int B, H, Lq, Lk, D;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
  int causal;
  int vec;  // 1: D % 4 == 0 and every row 16-byte aligned
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * LD + d] = src[(row0 + r) * row_stride + d] for r < ROWS and
// d < DK, zero where row0 + r >= nrows or d >= D.
template <int ROWS, int DK>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int nrows, int D, int vec) {
  if (vec) {
    constexpr int C = DK / 4;
    for (int idx = threadIdx.x; idx < ROWS * C; idx += NT) {
      const int r = idx / C, d = (idx - r * C) * 4;
      const bool ok = row0 + r < nrows && d < D;
      cp_async16(dst + r * LD + d,
                 ok ? src + (row0 + r) * row_stride + d : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DK; idx += NT) {
      const int r = idx / DK, d = idx - r * DK;
      const bool ok = row0 + r < nrows && d < D;
      cp_async4(dst + r * LD + d,
                ok ? src + (row0 + r) * row_stride + d : src, ok);
    }
  }
}

// x = big + small.  big is x rounded to the nearest TF32, ties away from
// zero: the value cvt.rna.tf32.f32 gives, formed with one integer add and
// one mask, cheaper than the conversion instruction.  small keeps
// x - big (exact in f32) as it is: the tensor cores read the 19 high bits
// of a .tf32 operand, so it enters the product truncated to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// NDT: head-dim steps of 8 (D <= 8 * NDT).  Fragment coordinates below:
// g = lane / 4 (row within 8), t = lane % 4.
template <int NDT>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(const Params p) {
  constexpr int DK = NDT * 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* kvs = qs + Q_FLOATS;                    // [2][K, V][BK][LD]

  const int BH = p.B * p.H;
  const int nq = (p.Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * BQ;  // heaviest tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the tile
  const int D = p.D;

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  int n_kt = (p.Lk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.Lq) - 1) / BK + 1);

  load_tile<BQ, DK>(qs, qb, p.q_sl, q0, p.Lq, D, p.vec);
  if (n_kt > 0) {
    load_tile<BK, DK>(kvs, kb, p.k_sl, 0, p.Lk, D, p.vec);
    load_tile<BK, DK>(kvs + KV_FLOATS, vb, p.v_sl, 0, p.Lk, D, p.vec);
  }
  cp_async_commit();

  float o[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  // rows qa = q0 + r0 + g and qa + 8; l is this lane's share of the sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qa = q0 + r0 + g;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_kt) {
      float* nxt = kvs + ((it + 1) & 1) * 2 * KV_FLOATS;
      load_tile<BK, DK>(nxt, kb, p.k_sl, k0 + BK, p.Lk, D, p.vec);
      load_tile<BK, DK>(nxt + KV_FLOATS, vb, p.v_sl, k0 + BK, p.Lk, D,
                        p.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it has landed for every thread

    const float* ks = kvs + (it & 1) * 2 * KV_FLOATS;
    const float* vs = ks + KV_FLOATS;
    if (!(p.causal && k0 > q0 + r0 + 15)) {
      // S = Q K^T: 16 rows x 64 keys, 8 n-steps of 8 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        const float* qr = qs + (r0 + g) * LD + kk * 8 + t;
        uint32_t ab[4], as[4];
        split(qr[0], ab[0], as[0]);
        split(qr[8 * LD], ab[1], as[1]);
        split(qr[4], ab[2], as[2]);
        split(qr[8 * LD + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
          uint32_t bb0, bs0, bb1, bs1;
          split(kr[0], bb0, bs0);
          split(kr[4], bb1, bs1);
          mma3(s[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }

      // scale, mask, online softmax; s[n][e] is row qa + 8 * (e >> 1),
      // key k0 + 8n + 2t + (e & 1)
      const bool masked = k0 + BK > p.Lk || (p.causal && k0 + BK - 1 > q0 + r0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * p.scale;
          if (masked) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            const int row = qa + 8 * (e >> 1);
            if (key >= p.Lk || (p.causal && row < key)) x = NEG_INF;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
        alpha[rr] = exp2f((m[rr] - m_new) * LOG2E);
        m[rr] = m_new;
      }
      const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], LOG2E, -ml[e >> 1]));
          rs[e >> 1] += s[n][e];
        }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int dn = 0; dn < NDT; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }

      // O += P V: k-step n covers keys k0 + 8n .. + 7, A column t taking
      // key 2t and column t + 4 key 2t + 1
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t ab[4], as[4];
        split(s[n][0], ab[0], as[0]);
        split(s[n][2], ab[1], as[1]);
        split(s[n][1], ab[2], as[2]);
        split(s[n][3], ab[3], as[3]);
        const float* v0 = vs + (n * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int dn = 0; dn < NDT; ++dn) {
          uint32_t bb0, bs0, bb1, bs1;
          split(v0[dn * 8], bb0, bs0);
          split(v0[LD + dn * 8], bb1, bs1);
          mma3(o[dn], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();  // every reader is done before the stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the CTA (n_kt == 0 leaves Q's)

  float* ob = p.out + b * p.o_sb + h * p.o_sh;
  float* lb = p.lse + (long long)bh * p.Lq;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float ll = fmaxf(quad_sum(l[rr]), 1e-30f);
    const int row = qa + 8 * rr;
    if (row >= p.Lq) continue;
    float* orow = ob + row * p.o_sl;
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (col < D) orow[col] = o[dn][2 * rr] / ll;
      if (col + 1 < D) orow[col + 1] = o[dn][2 * rr + 1] / ll;
    }
    if (t == 0) lb[row] = m[rr] + logf(ll);
  }
}

template <int NDT>
int launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)p.B * p.H * ((p.Lq + BQ - 1) / BQ);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_kernel<NDT><<<(unsigned)blocks, NT, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K3b: the backward.  Replaces no Pallas kernel: the JAX package's backward
// is plain JAX, mxnet_tpu/ops/attention.py::_flash_bwd_core (FA2 blockwise
// over K, wired in by jax.custom_vjp for out and for the (out, lse) pair).
// It computes the same function from q, k, v, the forward's out and lse,
// the cotangent do of out and an optional cotangent dlse of lse:
//
//   Dd  = sum_d do * out - dlse                    (B, H, Lq), one per row
//   p   = exp(scale * q.k - lse)  [0 where masked: causal qi < ki, ragged]
//   ds  = p * (do.v - Dd) * scale
//   dq  = ds K,   dk = ds^T Q,   dv = p^T dO
//
// What bounds it: five products of 2*L*L*D per (batch, head) where the
// forward has two, so operations again (the bytes read and written are
// about 8 * B*H*L*D floats, 0.08 ms at L = 2048, B = 4).  Each product is
// 3xTF32 on mma.sync, as in the forward (one TF32 pass misses 1e-4).
//
// Design: three launches, no atomics, so every output repeats bit for bit.
//   * a row pass: one warp per query row writes Dd (fixed shuffle sums);
//   * dK/dV: one CTA of 8 warps per (batch*head, 128-key tile); each warp
//     owns 16 keys and holds their dK and dV (16 x D each) in registers;
//     K and V stay in shared memory, and query tiles of 32 rows (Q, dO,
//     lse, Dd) stream through a two-stage cp.async ring, from the first
//     tile that can see the keys (causal) to the last.  S^T = K Q^T and
//     dP^T = V dO^T come out as C fragments with keys as rows; P^T and
//     dS^T feed dV += P^T dO and dK += dS^T Q as A fragments with the
//     forward's key renumbering (here of queries);
//   * dQ: one CTA of 8 warps per (batch*head, 128-row query tile), the
//     forward's layout: Q and dO in shared memory, key tiles of 32 (K, V)
//     through a two-stage ring up to the diagonal; S and dP in registers,
//     dQ += dS K from the C fragments.
// S and dP are computed twice (in both kernels): seven products where five
// are needed, in exchange for no cross-CTA reduction.  dq, dk and dv are
// written through their own strides.
// Shared memory: dK/dV 2 x 128 x 132 (K, V) + 2 stages of 2 x 32 x 132
// (Q, dO) + lse and Dd, 198.5 KB; dQ 2 x 128 x 132 + 2 stages of
// 2 x 32 x 132, 198 KB; one CTA per SM.

constexpr int BKV = 128;  // keys per dK/dV CTA (8 warps x 16)
constexpr int BQS = 32;   // query rows per dK/dV stage
constexpr int BKS = 32;   // keys per dQ stage
constexpr int TILE_FLOATS = 128 * LD;  // a 128-row tile of K, V, Q or dO
constexpr int STAGE_FLOATS = 32 * LD;  // a 32-row stage tile
constexpr size_t DKV_SMEM_BYTES =
    (size_t)(2 * TILE_FLOATS + 4 * STAGE_FLOATS + 4 * BQS) * sizeof(float);
constexpr size_t DQ_SMEM_BYTES =
    (size_t)(2 * TILE_FLOATS + 4 * STAGE_FLOATS) * sizeof(float);

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;
  const float* dlse;  // null: no lse cotangent
  float* dq;
  float* dk;
  float* dv;
  float* dd;  // (B, H, Lq): sum_d do * out - dlse
  int B, H, Lq, Lk, D;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  float scale;
  int causal;
  int vec;  // 1: D % 4 == 0 and every row of q, k, v, do 16-byte aligned
};

// one warp per row of (B, H, Lq), eight rows a block
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(
    const BwdParams p) {
  const long long row = (long long)blockIdx.x * NWARP + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Lq) return;
  const int i = (int)(row % p.Lq);
  const int bh = (int)(row / p.Lq);
  const int b = bh / p.H, h = bh % p.H;
  const float* o = p.out + b * p.o_sb + h * p.o_sh + i * p.o_sl;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh + i * p.do_sl;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.dd[row] = acc - (p.dlse ? p.dlse[row] : 0.f);
}

// a, the A fragment of rows (r, r + 8) x columns (c, c + 4) of a
// row-major tile in shared memory, split into big and small
__device__ __forceinline__ void a_frag(const float* x, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split(x[0], ab[0], as[0]);
  split(x[8 * LD], ab[1], as[1]);
  split(x[4], ab[2], as[2]);
  split(x[8 * LD + 4], ab[3], as[3]);
}

// the A fragment of a 16 x 8 block held as a C fragment: A column t takes
// C column 2t and A column t + 4 C column 2t + 1 (the renumbering of the
// forward's P V)
__device__ __forceinline__ void a_from_c(const float (&c)[4],
                                         uint32_t (&ab)[4],
                                         uint32_t (&as)[4]) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

// acc[dn] += A (16 x 8, renumbered as in a_from_c) X[rows 8n + 2t, + 1]
// for every 8-column step dn of D: X is a row-major tile in shared memory
// whose rows match A's renumbered columns
template <int NDT>
__device__ __forceinline__ void mma_rows(float (&acc)[NDT][4],
                                         const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4],
                                         const float* x) {
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn) {
    uint32_t bb0, bs0, bb1, bs1;
    split(x[dn * 8], bb0, bs0);
    split(x[LD + dn * 8], bb1, bs1);
    mma3(acc[dn], ab, as, bb0, bb1, bs0, bs1);
  }
}

// c[n] += A Y^T over the head dim: A rows from `a` (a row-major tile in
// shared memory, this warp's 16 rows), Y's rows n*8 .. n*8 + 7 from `y`
template <int NDT, int NN>
__device__ __forceinline__ void mma_abt(float (&c)[NN][4], const float* a,
                                        const float* y, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NDT; ++kk) {
    uint32_t ab[4], as[4];
    a_frag(a + g * LD + kk * 8 + t, ab, as);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float* yr = y + (n * 8 + g) * LD + kk * 8 + t;
      uint32_t bb0, bs0, bb1, bs1;
      split(yr[0], bb0, bs0);
      split(yr[4], bb1, bs1);
      mma3(c[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// dst[i] = src[row0 + i] for i < N, 0 past nrows
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int nrows) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool ok = row0 + i < nrows;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

template <int NDT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_kernel(
    const BwdParams p) {
  constexpr int DK = NDT * 8;
  constexpr int QN = BQS / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BKV][LD]
  float* vs = ks + TILE_FLOATS;                  // [BKV][LD]
  float* st = vs + TILE_FLOATS;                  // [2][Q, dO][BQS][LD]
  float* rs = st + 4 * STAGE_FLOATS;             // [2][lse, Dd][BQS]

  const int BH = p.B * p.H;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BKV;  // causal: heaviest tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int kw = k0 + r0;  // the warp's first key
  const int D = p.D;

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* db = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lb = p.lse + (long long)bh * p.Lq;
  const float* ddb = p.dd + (long long)bh * p.Lq;

  const int nqt = (p.Lq + BQS - 1) / BQS;
  // causal: the first query tile that holds a row qi >= k0
  const int qt0 = p.causal ? min(k0 / BQS, nqt) : 0;

  load_tile<BKV, DK>(ks, kb, p.k_sl, k0, p.Lk, D, p.vec);
  load_tile<BKV, DK>(vs, vb, p.v_sl, k0, p.Lk, D, p.vec);
  if (qt0 < nqt) {
    load_tile<BQS, DK>(st, qb, p.q_sl, qt0 * BQS, p.Lq, D, p.vec);
    load_tile<BQS, DK>(st + STAGE_FLOATS, db, p.do_sl, qt0 * BQS, p.Lq, D,
                       p.vec);
    load_vec<BQS>(rs, lb, qt0 * BQS, p.Lq);
    load_vec<BQS>(rs + BQS, ddb, qt0 * BQS, p.Lq);
  }
  cp_async_commit();

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  const float sl2 = p.scale * LOG2E;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int it = qt - qt0;
    const int q0 = qt * BQS;
    if (qt + 1 < nqt) {
      const int nx = (it + 1) & 1;
      float* sq = st + nx * 2 * STAGE_FLOATS;
      load_tile<BQS, DK>(sq, qb, p.q_sl, q0 + BQS, p.Lq, D, p.vec);
      load_tile<BQS, DK>(sq + STAGE_FLOATS, db, p.do_sl, q0 + BQS, p.Lq, D,
                         p.vec);
      load_vec<BQS>(rs + nx * 2 * BQS, lb, q0 + BQS, p.Lq);
      load_vec<BQS>(rs + nx * 2 * BQS + BQS, ddb, q0 + BQS, p.Lq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage it has landed for every thread

    const float* sq = st + (it & 1) * 2 * STAGE_FLOATS;
    const float* sdo = sq + STAGE_FLOATS;
    const float* sl = rs + (it & 1) * 2 * BQS;
    const float* sd = sl + BQS;
    if (!(p.causal && q0 + BQS - 1 < kw)) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries each;
      // s[n][e] is key kw + g + 8 * (e >> 1), query q0 + 8n + 2t + (e & 1)
      float s[QN][4], dp[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_abt<NDT, QN>(s, ks + r0 * LD, sq, g, t);
      mma_abt<NDT, QN>(dp, vs + r0 * LD, sdo, g, t);
      const bool masked = q0 + BQS > p.Lq || (p.causal && q0 < kw + 15);
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          float pv = exp2f(fmaf(s[n][e], sl2, -sl[qc] * LOG2E));
          if (masked) {
            const int qi = q0 + qc, key = kw + g + 8 * (e >> 1);
            if (qi >= p.Lq || (p.causal && qi < key)) pv = 0.f;
          }
          dp[n][e] = pv * (dp[n][e] - sd[qc]) * p.scale;  // dS^T
          s[n][e] = pv;                                   // P^T
        }
      // dV += P^T dO and dK += dS^T Q, k-step n over queries 8n .. 8n + 7
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        uint32_t ab[4], as[4];
        a_from_c(s[n], ab, as);
        mma_rows<NDT>(dv, ab, as, sdo + (n * 8 + 2 * t) * LD + g);
        a_from_c(dp[n], ab, as);
        mma_rows<NDT>(dk, ab, as, sq + (n * 8 + 2 * t) * LD + g);
      }
    }
    __syncthreads();  // every reader is done before the stage is refilled
  }
  cp_async_wait<0>();

  float* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kw + g + 8 * rr;
    if (key >= p.Lk) continue;
    float* kr = dkb + key * p.dk_sl;
    float* vr = dvb + key * p.dv_sl;
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (col < D) {
        kr[col] = dk[dn][2 * rr];
        vr[col] = dv[dn][2 * rr];
      }
      if (col + 1 < D) {
        kr[col + 1] = dk[dn][2 * rr + 1];
        vr[col + 1] = dv[dn][2 * rr + 1];
      }
    }
  }
}

template <int NDT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_kernel(
    const BwdParams p) {
  constexpr int DK = NDT * 8;
  constexpr int KN = BKS / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* dos = qs + TILE_FLOATS;                 // [BQ][LD]
  float* kvs = dos + TILE_FLOATS;                // [2][K, V][BKS][LD]

  const int BH = p.B * p.H;
  const int nq = (p.Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - blockIdx.x / BH) * BQ;  // heaviest tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int D = p.D;

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* db = p.dout + b * p.do_sb + h * p.do_sh;

  int n_kt = (p.Lk + BKS - 1) / BKS;
  if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.Lq) - 1) / BKS + 1);

  load_tile<BQ, DK>(qs, qb, p.q_sl, q0, p.Lq, D, p.vec);
  load_tile<BQ, DK>(dos, db, p.do_sl, q0, p.Lq, D, p.vec);
  if (n_kt > 0) {
    load_tile<BKS, DK>(kvs, kb, p.k_sl, 0, p.Lk, D, p.vec);
    load_tile<BKS, DK>(kvs + STAGE_FLOATS, vb, p.v_sl, 0, p.Lk, D, p.vec);
  }
  cp_async_commit();

  // rows qa and qa + 8: lse (times log2 e) and Dd
  const int qa = q0 + r0 + g;
  float ml[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qa + 8 * rr;
    const bool ok = row < p.Lq;
    ml[rr] = ok ? p.lse[(long long)bh * p.Lq + row] * LOG2E : 0.f;
    dr[rr] = ok ? p.dd[(long long)bh * p.Lq + row] : 0.f;
  }
  const float sl2 = p.scale * LOG2E;
  float dq[NDT][4];
#pragma unroll
  for (int dn = 0; dn < NDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BKS;
    if (it + 1 < n_kt) {
      float* nxt = kvs + ((it + 1) & 1) * 2 * STAGE_FLOATS;
      load_tile<BKS, DK>(nxt, kb, p.k_sl, k0 + BKS, p.Lk, D, p.vec);
      load_tile<BKS, DK>(nxt + STAGE_FLOATS, vb, p.v_sl, k0 + BKS, p.Lk, D,
                         p.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* ks = kvs + (it & 1) * 2 * STAGE_FLOATS;
    const float* vs = ks + STAGE_FLOATS;
    if (!(p.causal && k0 > q0 + r0 + 15)) {
      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys; s[n][e] is row
      // qa + 8 * (e >> 1), key k0 + 8n + 2t + (e & 1)
      float s[KN][4], dp[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_abt<NDT, KN>(s, qs + r0 * LD, ks, g, t);
      mma_abt<NDT, KN>(dp, dos + r0 * LD, vs, g, t);
      const bool masked =
          k0 + BKS > p.Lk || (p.causal && k0 + BKS - 1 > q0 + r0);
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = exp2f(fmaf(s[n][e], sl2, -ml[e >> 1]));
          if (masked) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            const int row = qa + 8 * (e >> 1);
            if (key >= p.Lk || (p.causal && row < key)) pv = 0.f;
          }
          s[n][e] = pv * (dp[n][e] - dr[e >> 1]) * p.scale;  // dS
        }
      // dQ += dS K, k-step n over keys k0 + 8n .. + 7
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        uint32_t ab[4], as[4];
        a_from_c(s[n], ab, as);
        mma_rows<NDT>(dq, ab, as, ks + (n * 8 + 2 * t) * LD + g);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qa + 8 * rr;
    if (row >= p.Lq) continue;
    float* qr = dqb + row * p.dq_sl;
#pragma unroll
    for (int dn = 0; dn < NDT; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (col < D) qr[col] = dq[dn][2 * rr];
      if (col + 1 < D) qr[col + 1] = dq[dn][2 * rr + 1];
    }
  }
}

template <int NDT>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Lq;
  const long long bh = (long long)p.B * p.H;
  const long long dq_blocks = bh * ((p.Lq + BQ - 1) / BQ);
  const long long dkv_blocks = bh * ((p.Lk + BKV - 1) / BKV);
  const long long row_blocks = (rows + NWARP - 1) / NWARP;
  if (rows <= 0) return 0;
  if (row_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL ||
      dkv_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<NDT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_delta_kernel<<<(unsigned)row_blocks, NT, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<NDT>
      <<<(unsigned)dq_blocks, NT, DQ_SMEM_BYTES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dkv_blocks > 0)
    flash_bwd_dkdv_kernel<NDT>
        <<<(unsigned)dkv_blocks, NT, DKV_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers;
// strides are in elements; the last dimension of q, k, v and out is
// contiguous; lse is a contiguous (B, H, Lq) f32 array.  Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int mxtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, int vec, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.scale = scale;
  p.causal = causal;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<4>(p, st);
  if (D <= 64) return launch<8>(p, st);
  return launch<16>(p, st);
}


// Plain C entry point of K3b, loaded with ctypes.  Pointers are device
// pointers (dlse may be null); strides are in elements; the last dimension
// of q, k, v, out, do, dq, dk and dv is contiguous; lse, dlse and dd are
// contiguous (B, H, Lq) f32 arrays, dd a scratch the call fills.  Launches
// three kernels on `stream` and returns the first error of
// cudaGetLastError() (0 when every launch was taken).
extern "C" int mxtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* dlse, void* dq, void* dk,
    void* dv, void* dd, int B, int H, int Lq, int Lk, int D,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dq_sb, long long dq_sh, long long dq_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    float scale, int causal, int vec, void* stream) {
  BwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<const float*>(out);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dd = static_cast<float*>(dd);
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk; p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sl = dq_sl;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.scale = scale;
  p.causal = causal;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_bwd<4>(p, st);
  if (D <= 64) return launch_bwd<8>(p, st);
  return launch_bwd<16>(p, st);
}
