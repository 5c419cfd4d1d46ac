// Flash-attention forward for Hopper (sm_90a), f32 in and out, on the
// tensor cores at f32 accuracy (3xTF32).
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
