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
// What bounds it: five products of 2*D operations per attended (query,
// key) pair, so operations (at L = 2048, D = 128 the bytes read and
// written are about 8 * B*H*L*D floats, 0.08 ms at B = 4).  Each product
// is 3xTF32, three TF32 tensor-core products summed in f32 (one TF32 pass
// in any of the five misses 1e-4, tests/test_torch_attention.py), so the
// bound is 3 * 10 * D * pairs / 495 TFLOP/s: 0.52 ms at B = 4, H = 8,
// L = 2048, causal.  mma.sync reaches about 310 of those 495 TFLOP/s on
// an H100 (chip_k3b_costs.py), 0.83 ms for the same work.
//
// Design: a row prologue, then one persistent kernel; five products; dq
// summed in a fixed order without floating-point atomics.
//   * prologue: one warp per query row writes Dd (fixed shuffle sums) and
//     zeroes the call's work counter and dq flags;
//   * work items are (batch*head, 64-key tile); one CTA per SM takes them
//     from an integer counter in a fixed order, key tile 0 of every head
//     first, then key tile 1, ...: under the causal mask the first keys
//     see every query, so the heaviest items start first and the light
//     ones fill the tail, whatever B*H (at B = 1 the time is the total
//     work over the SMs, not key tile 0's);
//   * an item keeps its K and V tile in shared memory and dK, dV (64 x D
//     each) in registers and walks its query tiles of 64 rows from the
//     last down to the first it can see (causal).  Per tile, 8 warps:
//     S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp, with P^T
//     and dS^T computed in registers and stored to shared memory;
//     dV += P^T dO (warps 0-3) and dK += dS^T Q (4-7), 32 keys x D/2 a
//     warp; the dQ part dS K, 32 queries x D/4 a warp.  S and dP are
//     computed once: five products, where separate dQ and dK/dV kernels
//     would recompute them in both (seven);
//   * dq is summed in global memory in ascending key-tile order: a tile's
//     part is added (key tile 0 stores it) once the tile's integer flag
//     says key tile j - 1 has added its own (thread 0 polls with an
//     acquire load; the CTA's stores are released by a fence and an
//     integer add).  The order depends on the shapes alone, so dq repeats
//     bit for bit.  An item waits only on an item of a smaller index (the
//     same head's previous key tile), which a running CTA holds, so the
//     waits cannot deadlock whatever the grid; walking the query tiles
//     from the last one puts the key tiles of a head on the same tile one
//     after another, so the waits are short.  The dq values a part adds
//     to arrive by cp.async under the dQ products.
//
// Products: all five on mma.sync.m16n8k8.tf32, not wgmma.  wgmma takes a
// .tf32 B operand (and A, when in shared memory) K-major only, so
// dV += P^T dO, dK += dS^T Q and dQ += dS K would need transposed copies of
// dO, Q and K, and 3xTF32 needs a big and a small copy of every operand it
// reads from shared memory; the register A operand (K or V for S^T and
// dP^T, 64 x D big and small) does not fit beside dK and dV in 255
// registers.  Shared memory at D = 128 (rows padded to 132 floats, P^T and
// dS^T to 68, so every fragment load hits 32 banks):
//
//                        this design          wgmma, big + small copies
//   K, V                  67,584              K, K^T, V         196,608
//   Q (2 stages)          67,584              Q, Q^T (2 stages) 262,144
//   dO (1; the next one   33,792              dO, dO^T          131,072
//     comes after dV)
//   lse, Dd (2 stages)     1,024
//   dS^T                  17,408
//   P^T, then old dq      33,792
//   total                221,184 of 232,448   over 589,000
//
// Split: an operand is split into a TF32 big part and the rest as its
// fragment is loaded, with two instructions: big = x with the low 13 bits
// cleared (rounding toward zero), small = x - big, exact in f32 and read
// by the tensor cores truncated to TF32.  Stored split copies would double
// the shared memory every operand takes (no room above) and the bytes
// every fragment load moves.
//
// Copies: cp.async (16 bytes where rows are 16-byte aligned and D % 4 == 0,
// 4 bytes otherwise, zero-filled past L and D), issued a tile ahead for Q,
// lse and Dd and after dV's products for dO.  TMA would take only the
// aligned views; the copies are 64 KB a tile against about 15 us of
// products.

constexpr int BKV = 64;   // keys per work item
constexpr int BQS = 64;   // query rows per step
constexpr int LDT = BQS + 4;  // row stride of P^T and dS^T
constexpr int TILE_KV = BKV * LD;
constexpr int TILE_Q = BQS * LD;
constexpr int TILE_P = BKV * LDT;
constexpr size_t BWD_SMEM_BYTES =
    (size_t)(2 * TILE_KV + 3 * TILE_Q + 4 * BQS + TILE_P +
             (TILE_P > TILE_Q ? TILE_P : TILE_Q)) *
    sizeof(float);

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
  int* work;  // [0] the item counter, then one dQ flag a (b*h, query tile)
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
  int vec;  // 1: D % 4 == 0 and every row of q, k, v, do, dq 16-byte aligned
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p),
      "r"(v)
      : "memory");
}

// x = big + small with big = x rounded toward zero to TF32 (the low 13
// bits cleared) and small = x - big, exact; the tensor cores read small's
// 19 high bits
__device__ __forceinline__ void split_rz(float x, uint32_t& big,
                                         uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[n] += A B_n in 3xTF32 for N independent accumulators, pass by pass
// (the small products first), so consecutive mma.sync never wait on each
// other's accumulator; b*[n] = {b0, b1} of B_n
template <int N>
__device__ __forceinline__ void mma3_passes(float (&c)[N][4],
                                            const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4],
                                            const uint32_t (&bb)[N][2],
                                            const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], as, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ab, bb[n][0], bb[n][1]);
}

// the A fragment of rows (r, r + 8) x columns (c, c + 4) of a row-major
// tile with row stride ld (x points at (r, c)), split
template <int ld>
__device__ __forceinline__ void a_frag(const float* x, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split_rz(x[0], ab[0], as[0]);
  split_rz(x[8 * ld], ab[1], as[1]);
  split_rz(x[4], ab[2], as[2]);
  split_rz(x[8 * ld + 4], ab[3], as[3]);
}

// the column where P^T and dS^T keep query ql: inside each group of 8,
// query 2u + e sits at column u + 4e, so an A fragment read at columns
// (t, t + 4) holds queries (2t, 2t + 1), the rows 2t and 2t + 1 a B
// fragment of dO or Q reads (conflict-free at stride 132)
__device__ __forceinline__ int pcol(int ql) {
  return (ql & ~7) + ((ql & 7) >> 1) + 4 * (ql & 1);
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

// one warp per row of (B, H, Lq), eight rows a block; the first threads
// also zero the work counter and the dQ flags, and with Lk == 0 (no key
// tile, no item) the rows write dq = 0
__global__ void __launch_bounds__(NT) flash_bwd_prologue_kernel(
    const BwdParams p, int nwork) {
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  if (tid < nwork) p.work[tid] = 0;
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
  if (p.Lk == 0) {
    float* qr = p.dq + b * p.dq_sb + h * p.dq_sh + i * p.dq_sl;
    for (int d = lane; d < p.D; d += 32) qr[d] = 0.f;
  }
}

template <int NDT>
__global__ void __launch_bounds__(NT, 1) flash_bwd_kernel(
    const BwdParams p) {
  constexpr int DK = NDT * 8;
  constexpr int NH = NDT / 2;  // dK/dV: 8-column steps a warp (D/2)
  constexpr int NG = NH < 4 ? NH : 4;  // of them a pass group
  constexpr int NQ = NDT / 4;  // dQ: 8-column steps a warp (D/4)
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BKV][LD]
  float* vs = ks + TILE_KV;                      // [BKV][LD]
  float* qst = vs + TILE_KV;           // [2][BQS][LD] Q, two stages
  float* dos = qst + 2 * TILE_Q;       // [BQS][LD] dO
  float* vecs = dos + TILE_Q;          // [2][lse, Dd][BQS]
  float* dst = vecs + 4 * BQS;         // [BKV][LDT] dS^T
  float* pt = dst + TILE_P;            // [BKV][LDT] P^T, queries by pcol
  float* dqo = pt;  // [BQS][LD] after dV's products: the dq the part adds to
  __shared__ int item_s;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int D = p.D;
  const int BH = p.B * p.H;
  const int nkt = (p.Lk + BKV - 1) / BKV;
  const int nqt = (p.Lq + BQS - 1) / BQS;
  const int total = BH * nkt;
  const float sl2 = p.scale * LOG2E;

  // warp roles: phase 1 on keys kr .. kr + 15 x queries qc .. qc + 31;
  // dV (warps 0-3) / dK (4-7) on keys 32 mh .. + 31, columns ch * D/2 ..;
  // the dQ part on queries 32 qh .. + 31, columns cq * D/4 ..
  const bool second = warp >= 4;
  const int kr = (warp & 3) * 16, qc = (warp >> 2) * 32;
  const int mh = (warp & 3) >> 1, ch = warp & 1;
  const int qh = warp & 1, cq = warp >> 1;

  for (;;) {
    __syncthreads();  // the last item's reads of item_s are done
    if (threadIdx.x == 0) item_s = atomicAdd(p.work, 1);
    __syncthreads();
    const int n = item_s;
    if (n >= total) break;
    // item n -> (key tile j, batch*head bh), key tiles ascending
    const int j = n / BH, bh = n - j * BH;
    const int b = bh / p.H, h = bh % p.H;
    const int k0 = j * BKV;
    // causal: the first query tile that holds a row qi >= k0
    const int i_min = p.causal ? k0 / BQS : 0;
    const int steps = max(0, nqt - i_min);
    int* flags = p.work + 1 + (long long)bh * nqt;

    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    const float* kb = p.k + b * p.k_sb + h * p.k_sh;
    const float* vb = p.v + b * p.v_sb + h * p.v_sh;
    const float* db = p.dout + b * p.do_sb + h * p.do_sh;
    const float* lb = p.lse + (long long)bh * p.Lq;
    const float* ddb = p.dd + (long long)bh * p.Lq;
    float* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;

    load_tile<BKV, DK>(ks, kb, p.k_sl, k0, p.Lk, D, p.vec);
    load_tile<BKV, DK>(vs, vb, p.v_sl, k0, p.Lk, D, p.vec);
    if (steps > 0) {
      const int q0 = (nqt - 1) * BQS;
      load_tile<BQS, DK>(qst, qb, p.q_sl, q0, p.Lq, D, p.vec);
      load_tile<BQS, DK>(dos, db, p.do_sl, q0, p.Lq, D, p.vec);
      load_vec<BQS>(vecs, lb, q0, p.Lq);
      load_vec<BQS>(vecs + BQS, ddb, q0, p.Lq);
    }
    cp_async_commit();

    float acc[2][NH][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nn = 0; nn < NH; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nn][e] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const int q0 = (nqt - 1 - s) * BQS;
      const float* sq = qst + (s & 1) * TILE_Q;
      const float* sl = vecs + (s & 1) * 2 * BQS;
      const float* sd = sl + BQS;
      cp_async_wait<0>();
      // stage s (and K, V) landed; every warp is done with step s - 1
      __syncthreads();
      if (s + 1 < steps) {  // the next Q, lse and Dd, into the other buffer
        const int q1 = q0 - BQS;
        load_tile<BQS, DK>(qst + ((s + 1) & 1) * TILE_Q, qb, p.q_sl, q1,
                           p.Lq, D, p.vec);
        float* nv = vecs + ((s + 1) & 1) * 2 * BQS;
        load_vec<BQS>(nv, lb, q1, p.Lq);
        load_vec<BQS>(nv + BQS, ddb, q1, p.Lq);
        cp_async_commit();
      }

      // phase 1: S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a
      // warp; c[0][n][e] (S^T) and c[1][n][e] (dP^T) are key
      // k0 + kr + g + 8 (e >> 1), query q0 + qc + 8n + 2t + (e & 1)
      const bool dead = k0 + kr >= p.Lk ||
                        (p.causal && q0 + qc + 31 < k0 + kr);
      float c[2][4][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nq = 0; nq < 4; ++nq)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[x][nq][e] = 0.f;
      if (!dead) {
        const float* kp = ks + (kr + g) * LD + t;
        const float* vp = vs + (kr + g) * LD + t;
        const float* qp = sq + (qc + g) * LD + t;
        const float* op = dos + (qc + g) * LD + t;
#pragma unroll
        for (int kk = 0; kk < NDT; ++kk) {
          uint32_t ab[4], as[4], bb[4][2], bs[4][2];
          a_frag<LD>(kp + kk * 8, ab, as);
#pragma unroll
          for (int nq = 0; nq < 4; ++nq) {
            const float* br = qp + nq * 8 * LD + kk * 8;
            split_rz(br[0], bb[nq][0], bs[nq][0]);
            split_rz(br[4], bb[nq][1], bs[nq][1]);
          }
          mma3_passes<4>(c[0], ab, as, bb, bs);
          a_frag<LD>(vp + kk * 8, ab, as);
#pragma unroll
          for (int nq = 0; nq < 4; ++nq) {
            const float* br = op + nq * 8 * LD + kk * 8;
            split_rz(br[0], bb[nq][0], bs[nq][0]);
            split_rz(br[4], bb[nq][1], bs[nq][1]);
          }
          mma3_passes<4>(c[1], ab, as, bb, bs);
        }
      }
      // P^T (masked to 0) and dS^T = P^T (dP^T - Dd) scale into shared
      // memory
      const bool masked = k0 + kr + 16 > p.Lk || q0 + qc + 32 > p.Lq ||
                          (p.causal && q0 + qc < k0 + kr + 15);
#pragma unroll
      for (int nq = 0; nq < 4; ++nq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kr + g + 8 * (e >> 1);
          const int ql = qc + nq * 8 + 2 * t + (e & 1);
          float pv = dead ? 0.f
                          : exp2f(fmaf(c[0][nq][e], sl2, -sl[ql] * LOG2E));
          if (masked) {
            const int key = k0 + kl, qi = q0 + ql;
            if (key >= p.Lk || qi >= p.Lq || (p.causal && qi < key))
              pv = 0.f;
          }
          const int at = kl * LDT + pcol(ql);
          pt[at] = pv;
          dst[at] = pv * (c[1][nq][e] - sd[ql]) * p.scale;
        }
      __syncthreads();  // P^T and dS^T written

      // phase 2a: dV += P^T dO (warps 0-3), dK += dS^T Q (4-7): 32 keys x
      // D/2, k-steps of 8 queries (A columns t, t + 4 hold queries 2t,
      // 2t + 1, the B rows read)
      {
        const float* ap = (second ? dst : pt) + (32 * mh + g) * LDT + t;
        const float* bp = (second ? sq : dos) + 2 * t * LD + ch * (DK / 2) + g;
#pragma unroll
        for (int kq = 0; kq < BQS / 8; ++kq) {
          uint32_t ab[2][4], as[2][4];
          a_frag<LDT>(ap + kq * 8, ab[0], as[0]);
          a_frag<LDT>(ap + 16 * LDT + kq * 8, ab[1], as[1]);
          const float* br = bp + kq * 8 * LD;
#pragma unroll
          for (int n0 = 0; n0 < NH; n0 += NG) {
            uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
            for (int nn = 0; nn < NG; ++nn) {
              split_rz(br[(n0 + nn) * 8], bb[nn][0], bs[nn][0]);
              split_rz(br[LD + (n0 + nn) * 8], bb[nn][1], bs[nn][1]);
            }
#pragma unroll
            for (int nn = 0; nn < NG; ++nn) {
              mma_tf32(acc[0][n0 + nn], ab[0], bs[nn][0], bs[nn][1]);
              mma_tf32(acc[1][n0 + nn], ab[1], bs[nn][0], bs[nn][1]);
            }
#pragma unroll
            for (int nn = 0; nn < NG; ++nn) {
              mma_tf32(acc[0][n0 + nn], as[0], bb[nn][0], bb[nn][1]);
              mma_tf32(acc[1][n0 + nn], as[1], bb[nn][0], bb[nn][1]);
            }
#pragma unroll
            for (int nn = 0; nn < NG; ++nn) {
              mma_tf32(acc[0][n0 + nn], ab[0], bb[nn][0], bb[nn][1]);
              mma_tf32(acc[1][n0 + nn], ab[1], bb[nn][0], bb[nn][1]);
            }
          }
        }
      }

      // wait until key tile j - 1 has added its part of this query tile
      // (thread 0; the barrier below passes the acquire on): a predecessor
      // is a running CTA's item and takes microseconds, so 2^24 polls
      // (seconds) mean a broken order and fail the launch rather than hang
      // the card
      if (threadIdx.x == 0 && j > 0) {
        int ns = 32;
        for (int polls = 0; ld_acquire(flags + q0 / BQS) != j; ++polls) {
          if (polls == (1 << 24)) __trap();
          __nanosleep(ns);
          ns = min(ns * 2, 256);
        }
      }
      __syncthreads();  // dO and P^T read; this tile's turn has come
      // the dq this tile's part adds to, into P^T's place, under the
      // products below (16-byte copies, which bypass L1; rows that are not
      // 16-byte aligned load it at the add instead); then the next dO
      if (j > 0 && p.vec)
        load_tile<BQS, DK>(dqo, dqb, p.dq_sl, q0, p.Lq, D, p.vec);
      cp_async_commit();
      if (s + 1 < steps) {
        load_tile<BQS, DK>(dos, db, p.do_sl, q0 - BQS, p.Lq, D, p.vec);
        cp_async_commit();
      }

      // phase 2b: the dQ part dS K, 32 queries x D/4 a warp, k-steps of 8
      // keys (A columns t, t + 4 hold keys 2t, 2t + 1)
      float part[2][NQ][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nn][e] = 0.f;
      {
        int cm[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          cm[mt][0] = pcol(32 * qh + 16 * mt + g);
          cm[mt][1] = pcol(32 * qh + 16 * mt + 8 + g);
        }
        const float* kp = ks + 2 * t * LD + cq * (DK / 4) + g;
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk) {
          const float* a0 = dst + (kk * 8 + 2 * t) * LDT;
          const float* br = kp + kk * 8 * LD;
          uint32_t bb[NQ][2], bs[NQ][2];
#pragma unroll
          for (int nn = 0; nn < NQ; ++nn) {
            split_rz(br[nn * 8], bb[nn][0], bs[nn][0]);
            split_rz(br[LD + nn * 8], bb[nn][1], bs[nn][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t ab[4], as[4];
            split_rz(a0[cm[mt][0]], ab[0], as[0]);
            split_rz(a0[cm[mt][1]], ab[1], as[1]);
            split_rz(a0[LDT + cm[mt][0]], ab[2], as[2]);
            split_rz(a0[LDT + cm[mt][1]], ab[3], as[3]);
            mma3_passes<NQ>(part[mt], ab, as, bb, bs);
          }
        }
      }
      if (s + 1 < steps) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the old dq has landed for every thread
      // key tile 0 stores its part; the others add it to the sum so far
      // (8-byte stores where rows are 16-byte aligned)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int rl = 32 * qh + 16 * mt + g + 8 * rr;
            const int col = cq * (DK / 4) + nn * 8 + 2 * t;
            if (q0 + rl >= p.Lq) continue;
            float2 v = make_float2(part[mt][nn][2 * rr],
                                   part[mt][nn][2 * rr + 1]);
            float* ptr = dqb + (q0 + rl) * p.dq_sl + col;
            if (p.vec) {
              if (j > 0) {
                const float2 o =
                    *reinterpret_cast<const float2*>(dqo + rl * LD + col);
                v.x = o.x + v.x;
                v.y = o.y + v.y;
              }
              if (col < D) __stcg(reinterpret_cast<float2*>(ptr), v);
            } else {
              if (col < D) __stcg(ptr, j > 0 ? __ldcg(ptr) + v.x : v.x);
              if (col + 1 < D)
                __stcg(ptr + 1, j > 0 ? __ldcg(ptr + 1) + v.y : v.y);
            }
          }
      __syncthreads();  // every thread's adds issued
      if (threadIdx.x == 0) red_release(flags + q0 / BQS, 1);
    }
    cp_async_wait<0>();  // no copy outlives the item (steps == 0 leaves K/V's)

    // dV (warps 0-3) or dK (4-7), rows of keys k0 + 32 mh + 16 mt + g (+8)
    float* ob = second ? p.dk + b * p.dk_sb + h * p.dk_sh
                       : p.dv + b * p.dv_sb + h * p.dv_sh;
    const long long osl = second ? p.dk_sl : p.dv_sl;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = k0 + 32 * mh + 16 * mt + g + 8 * rr;
        if (key >= p.Lk) continue;
        float* orow = ob + key * osl;
#pragma unroll
        for (int nn = 0; nn < NH; ++nn) {
          const int col = ch * (DK / 2) + nn * 8 + 2 * t;
          if (col < D) orow[col] = acc[mt][nn][2 * rr];
          if (col + 1 < D) orow[col + 1] = acc[mt][nn][2 * rr + 1];
        }
      }
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

// int32 words of the work array of a call: the item counter and one dQ
// flag a (batch*head, query tile)
long long bwd_work_words(int B, int H, int Lq) {
  return (long long)B * H * ((Lq + BQS - 1) / BQS) + 1;
}

template <int NDT>
int launch_bwd(BwdParams p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Lq;
  if (rows <= 0) return 0;
  const long long nwork = bwd_work_words(p.B, p.H, p.Lq);
  const long long row_blocks = (rows + NWARP - 1) / NWARP;
  const long long bh = (long long)p.B * p.H;
  const long long nkt = (p.Lk + BKV - 1) / BKV;
  const long long items = bh * nkt;
  if (row_blocks > 0x7fffffffLL || items > 0x7fffffffLL ||
      nwork > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<NDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_prologue_kernel<<<(unsigned)row_blocks, NT, 0, stream>>>(
      p, (int)nwork);
  err = cudaGetLastError();
  if (err != cudaSuccess || items == 0) return (int)err;
  const long long grid = min(items, (long long)sm_count());
  flash_bwd_kernel<NDT><<<(unsigned)grid, NT, BWD_SMEM_BYTES, stream>>>(p);
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



// int32 words of the work array K3b's entry point takes for (B, H, Lq)
extern "C" long long mxtt_flash_attention_bwd_work_words(int B, int H,
                                                         int Lq) {
  return bwd_work_words(B, H, Lq);
}

// Plain C entry point of K3b, loaded with ctypes.  Pointers are device
// pointers (dlse may be null); strides are in elements; the last dimension
// of q, k, v, out, do, dq, dk and dv is contiguous; lse, dlse and dd are
// contiguous (B, H, Lq) f32 arrays, dd a scratch the call fills, work a
// scratch of mxtt_flash_attention_bwd_work_words int32 words.  Launches a
// row prologue and the persistent kernel on `stream` and returns the first
// error of cudaGetLastError() (0 when every launch was taken).
extern "C" int mxtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* dlse, void* dq, void* dk,
    void* dv, void* dd, void* work, int B, int H, int Lq, int Lk, int D,
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
  p.work = static_cast<int*>(work);
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
