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
// Design (simple first; a persistent kernel that splits H across SMs
// and keeps its slice of w4 in shared memory, with a grid barrier per
// step, is later work):
//   * w4 (640 KB at H = 200) does not fit a block's 227 KB of shared
//     memory, but batch rows of an LSTM never interact.  So one block owns
//     ROWS whole batch rows for the whole sequence (grid = N / ROWS
//     blocks, no communication between blocks).  Its h and c live in
//     shared memory (h double-buffered, one __syncthreads per step), and
//     w4 streams from L2 every step (it fits the 50 MB L2 many times).
//   * Forward: thread j owns output column j of every gate and every row
//     of the block, so the four gates of (row, j) meet in its registers
//     and the cell update needs no exchange.  w4[k][i][j] is read along j
//     by neighbouring threads (coalesced); h[r][i] is a shared-memory
//     broadcast.  H = 200 is ragged for warps: blockDim is H rounded up
//     to 32, threads past H idle.
//   * Backward recurrence: thread j forms dz for column j (elementwise),
//     writes it to dxp and to shared memory; after a barrier thread i
//     forms dh[r][i] = sum_k sum_j dz_k[r][j] w4[k][i][j], reading a
//     transposed copy w4t[k][j][i] (made once per call into the work
//     space) so that this read is coalesced too.
//   * dw4 and dbh reduce over all T and N, across blocks.  No atomics: a
//     second kernel computes them as one product per gate,
//     [h_prev; 1]^T (H+1 x T*N) times dz_k (T*N x H), the row of ones
//     giving dbh, in 32x32 output tiles with the T*N axis walked in a
//     fixed order.  Runs repeat bit for bit.
// Numerics: expf-based sigmoid and tanhf in f32, no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 2;       // batch rows one block owns
constexpr int MAX_H = 1024;   // one thread per column, at most 1024
constexpr int TILE = 32;      // dw4 output tile (TILE x TILE)
constexpr int KT = 32;        // T*N values per stage of the dw4 product
constexpr int RT = 256;       // threads of the dw4 kernel

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

// w4t[k][j][i] = w4[k][i][j]: the layout K6's dh product reads along i.
__global__ void lstm_transpose_kernel(const float* __restrict__ w4,
                                      float* __restrict__ w4t, int H) {
  const size_t HH = (size_t)H * H;
  const size_t total = 4 * HH;
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const size_t k = o / HH;
    const size_t rem = o - k * HH;
    const size_t j = rem / H;
    const size_t i = rem - j * H;
    w4t[o] = w4[k * HH + i * H + j];
  }
}

// K6's recurrence.  Shared memory: dz[4][ROWS][H], dh[ROWS][H], dc[ROWS][H].
__global__ void lstm_bwd_kernel(const float* __restrict__ gates,
                                const float* __restrict__ cs,
                                const float* __restrict__ w4t,
                                const float* __restrict__ c0,
                                const float* __restrict__ dys,
                                const float* __restrict__ dhT,
                                const float* __restrict__ dcT,
                                float* __restrict__ dxp,
                                float* __restrict__ dh0,
                                float* __restrict__ dc0, int T, int N,
                                int H) {
  extern __shared__ float sm[];
  float* dzs = sm;                       // [4][ROWS][H]
  float* dhs = sm + 4 * ROWS * H;        // [ROWS][H]
  float* dcs = dhs + ROWS * H;           // [ROWS][H]
  const int n0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, N - n0);
  const size_t HH = (size_t)H * H;
  const size_t NH = (size_t)N * H;
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    const int r = idx / H;
    const size_t src = (size_t)(n0 + r) * H + (idx - r * H);
    dhs[idx] = r < rows ? dhT[src] : 0.f;
    dcs[idx] = r < rows ? dcT[src] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) dzs[k * ROWS * H + idx] = 0.f;
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        const int n = n0 + r;
        const size_t xo = ((size_t)t * 4 * N + n) * H + j;
        const size_t yo = ((size_t)t * N + n) * H + j;
        const float gi = gates[xo];
        const float gf = gates[xo + NH];
        const float gg = gates[xo + 2 * NH];
        const float go = gates[xo + 3 * NH];
        const float c = cs[yo];
        const float c_prev = t > 0 ? cs[yo - NH] : c0[(size_t)n * H + j];
        const float dh = dhs[r * H + j] + dys[yo];
        const float tc = tanhf(c);
        const float dout = dh * tc;
        const float dc = dcs[r * H + j] + dh * go * (1.0f - tc * tc);
        const float dzi = dc * gg * gi * (1.0f - gi);
        const float dzf = dc * c_prev * gf * (1.0f - gf);
        const float dzg = dc * gi * (1.0f - gg * gg);
        const float dzo = dout * go * (1.0f - go);
        dxp[xo] = dzi;
        dxp[xo + NH] = dzf;
        dxp[xo + 2 * NH] = dzg;
        dxp[xo + 3 * NH] = dzo;
        dzs[(0 * ROWS + r) * H + j] = dzi;
        dzs[(1 * ROWS + r) * H + j] = dzf;
        dzs[(2 * ROWS + r) * H + j] = dzg;
        dzs[(3 * ROWS + r) * H + j] = dzo;
        dcs[r * H + j] = dc * gf;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* w = w4t + k * HH + i;
        const float* dz = dzs + k * ROWS * H;
#pragma unroll 4
        for (int j = 0; j < H; ++j) {
          const float wv = __ldg(w + (size_t)j * H);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(dz[r * H + j], wv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dhs[r * H + i] = acc[r];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x) {
    const size_t dst = (size_t)n0 * H + idx;
    dh0[dst] = dhs[idx];
    dc0[dst] = dcs[idx];
  }
}

// dw4[k][i][j] = sum_{t,n} h_prev[t][n][i] * dxp[t][k][n][j] and, as the
// extra row i = H (h_prev taken as 1), dbh[k][j] = sum_{t,n} dxp[t][k][n][j].
// h_prev[t] is ys[t-1], and h0 at t = 0.  Grid: (j tiles, i tiles over
// H + 1 rows, 4 gates); each thread sums 4 outputs over T*N in order.
__global__ void __launch_bounds__(RT)
    lstm_bwd_params_kernel(const float* __restrict__ ys,
                           const float* __restrict__ h0,
                           const float* __restrict__ dxp,
                           float* __restrict__ dw4, float* __restrict__ dbh,
                           int T, int N, int H) {
  __shared__ float As[KT][TILE + 1];
  __shared__ float Bs[KT][TILE + 1];
  const int k = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % TILE;
  const int ty = threadIdx.x / TILE;  // 0..7
  const int KK = T * N;
  const size_t NH = (size_t)N * H;
  float acc[TILE / 8];
#pragma unroll
  for (int q = 0; q < TILE / 8; ++q) acc[q] = 0.f;
  for (int kb = 0; kb < KK; kb += KT) {
    for (int idx = threadIdx.x; idx < KT * TILE; idx += RT) {
      const int kl = idx / TILE;
      const int ii = idx - kl * TILE;
      const int kk = kb + kl;
      const int i = i0 + ii;
      const int j = j0 + ii;
      float a = 0.f, b = 0.f;
      if (kk < KK) {
        const int t = kk / N;
        const int n = kk - t * N;
        if (i < H)
          a = t == 0 ? h0[(size_t)n * H + i] : ys[(size_t)(kk - N) * H + i];
        else if (i == H)
          a = 1.0f;
        if (j < H) b = dxp[((size_t)t * 4 + k) * NH + (size_t)n * H + j];
      }
      As[kl][ii] = a;
      Bs[kl][ii] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int kl = 0; kl < KT; ++kl) {
      const float b = Bs[kl][tx];
#pragma unroll
      for (int q = 0; q < TILE / 8; ++q)
        acc[q] = fmaf(As[kl][ty + 8 * q], b, acc[q]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < TILE / 8; ++q) {
    const int i = i0 + ty + 8 * q;
    if (i < H)
      dw4[((size_t)k * H + i) * H + j] = acc[q];
    else if (i == H)
      dbh[(size_t)k * H + j] = acc[q];
  }
}

}  // namespace

// Floats of work space one call needs (K6: the transposed w4, 4*H*H; K4
// and K5: none), or -1 for a shape the kernels do not take: H above
// MAX_H (one thread per column) or T*4*N*H at or above 2^31 (int offsets
// of the dw4 kernel).  The wrappers size their allocation from this, so
// the limits live here only.
extern "C" long long mxtt_lstm_work_floats(long long T, long long N,
                                           long long H, int bwd) {
  if (T <= 0 || N <= 0 || H <= 0 || H > MAX_H) return -1;
  if (T * 4 * N * H >= (1LL << 31)) return -1;
  return bwd ? 4 * H * H : 0;
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
  float* w4t = work;
  const int blocks = (int)((4LL * H * H + 255) / 256);
  lstm_transpose_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, st>>>(
      w4, w4t, H);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = (size_t)6 * ROWS * H * sizeof(float);
  lstm_bwd_kernel<<<(N + ROWS - 1) / ROWS, threads_for(H), smem, st>>>(
      gates, cs, w4t, c0, dys, dhT, dcT, dxp, dh0, dc0, T, N, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((H + TILE - 1) / TILE, (H + 1 + TILE - 1) / TILE, 4);
  lstm_bwd_params_kernel<<<grid, RT, 0, st>>>(ys, h0, dxp, dw4, dbh, T, N,
                                              H);
  return (int)cudaGetLastError();
}
