// Kernels K8 and K8b: ROI max pooling (Fast R-CNN), forward and backward,
// for the ROIPooling op of Faster R-CNN's detection head.
//
// Replaces no Pallas kernel.  The JAX package runs ROIPooling as plain JAX
// (mxnet_tpu/ops/spatial.py:28 `_roi_pooling`): a vmap over the ROIs of a
// masked maximum over a (ph, pw, H, W) membership mask per ROI, which XLA
// fuses away.  Eager PyTorch cannot: at Faster R-CNN's training size (2000
// ROIs, 512 channels, a 37x62 map, 7x7 bins) the mask is 1.15e11 elements,
// and a loop over ROIs or bins launches thousands of kernels a step.
//
// K8 (forward) is three kernels in one call: a channels-last copy of the
// map, xt (B, H, W, C); a bounds kernel, one thread a ROI, that rounds the
// ROI onto the map and writes its batch index and the row and column
// extents of its bins into a small int32 array; and the pooling kernel, a
// block of eight warps per (ROI, tile of 32 channels).  A warp's lanes are
// 32 neighbouring channels of one pixel, so every load is one 128-byte
// line of xt, and all lanes walk the same bin in the same order (no
// divergence); the warps share the ROI's bins.  The block stages its
// maxima in shared memory and writes them as one contiguous run of
// out[r, c0:c0 + 32].  An empty bin, or one whose maximum is not finite
// (an infinite or NaN pixel), writes 0, as the JAX function's
// `where(isfinite(out), out, 0)` does.  The caller keeps xt and the bounds
// for K8b; K8 writes no tie counts.
//
// K8b (backward) is a gather with no floating-point atomics.  dx[b, c, h,
// w] is the sum over the ROIs r of image b, in ascending r, of part_r, and
// part_r the sum over the bins (i, j) of r holding (h, w), in ascending
// (i, j), of g[r, c, i, j] / n where x equals the bin's maximum and n, the
// pixels equal to it, is above 0.  Dividing by n is the JAX package's
// rule: `jnp.max`'s gradient splits a tie equally among the tied pixels.
// One block takes a tile of the map: a band of rows (the full width when
// it fits, else a run of columns) of one image and 32 channels, each of
// its BWD_THREADS threads summing up to PMAX pixels in registers.  They
// test ROIs a block's worth at a time against the tile and compact the ids
// that meet it, in ascending order, into shared memory (a warp ballot and
// a prefix count: no integer atomics, so the same list every launch).
// The block then takes the listed ROIs in steps: a step holds up to
// GROUP ROIs whose bins meeting the tile fit CAP bins (a ROI with more
// is split by bin rows, its partial sums kept in shared memory).  For a
// step the block copies the ROIs' bounds and g of those bins into shared
// memory (cp.async); each warp rebuilds the maximum and the tie count of
// some of the bins from xt, which stays in L2 (4.7 MB at Faster R-CNN's
// size), so neither the maxima nor any count is read back; then each
// thread adds, for each of its pixels a ROI covers, the ROI's share (its
// bins holding the pixel in ascending order) to the pixel's sum.  The
// tile is written to dx along w through shared memory.  Every pixel's sum
// is taken in the order of a thread-a-pixel gather over every ROI, with
// the same operations, so the result equals that gather's bit for bit,
// launch after launch.
//
// What bounds them: ROI pooling itself needs to read the map and the ROIs
// and write the maxima (205 MB at 2000 ROIs), and its backward to read the
// map, the ROIs and g and write dx (210 MB).  K8 also writes and reads xt
// (9.5 MB); K8b reads g of a bin once for each band it meets.  Both read
// each bin's pixels again from L2 (the sum of the bins' areas times the
// channels, about twice the ROIs' areas with the bins' shared edges: 2.4
// GB for K8 at Faster R-CNN's 2000 ROIs), and K8b rebuilds a bin in each
// band it meets and walks each listed ROI's pixels of its tile; K8b's
// steps wait on L2 in turn, so it is latency-bound.

// Numerics: the bounds are the JAX function's f32 arithmetic, every
// operation rounded on its own (__fmul_rn etc.: no FMA contraction):
// floor(v + 0.5) rounding of roi * spatial_scale, bin = max(extent + 1,
// 1) / pooled, floor(i * bin) + start and ceil((i + 1) * bin) + start
// clipped to [0, H]; the batch index truncated from roi[0], a negative one
// counted from the end and then clamped, as a JAX gather does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads a block: bounds kernel
constexpr int MAX_POOL = 64;
constexpr int CT = 32;          // channels a block takes: a warp's lanes
constexpr int TPAD = CT + 1;    // floats a pixel or a bin holds in shared
                                // memory: no bank conflict along either
constexpr int FWD_WARPS = 8;
constexpr int FWD_BINS = 256;   // bins K8 stages at a time
constexpr int BWD_WARPS = 16;   // K8b: warps a block
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int PMAX = 8;         // K8b: tile pixels a thread sums
constexpr int SCAN = 8;         // K8b: loads a lane issues at once in a bin
constexpr int GROUP = 8;        // K8b: ROIs a step
constexpr int CAP = 128;        // K8b: bins a step
static_assert(CAP >= MAX_POOL, "a step holds a ROI's bin row");
constexpr int TR = 32;          // the channels-last copy's tile
constexpr int SMEM_LIMIT = 227 * 1024;

// A ROI's bounds, `stride` ints: b, hs[ph], he[ph], ws[pw], we[pw].
__host__ __device__ __forceinline__ int bounds_stride(int ph, int pw) {
  return 1 + 2 * ph + 2 * pw;
}

__device__ __forceinline__ float round_half_up(float v, float scale) {
  return floorf(__fadd_rn(__fmul_rn(v, scale), 0.5f));
}

__device__ __forceinline__ int clip_to(float v, int n) {
  return (int)fminf(fmaxf(v, 0.f), (float)n);
}

__global__ void roi_bounds_kernel(const float* __restrict__ rois, int R,
                                  int B, int H, int W, int ph, int pw,
                                  float scale, int* __restrict__ bounds) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* roi = rois + 5 * (size_t)r;
  int* o = bounds + (size_t)r * bounds_stride(ph, pw);
  int b = __float2int_rz(roi[0]);
  if (b < 0) b += B;
  o[0] = min(max(b, 0), B - 1);
  const float x1 = round_half_up(roi[1], scale);
  const float y1 = round_half_up(roi[2], scale);
  const float x2 = round_half_up(roi[3], scale);
  const float y2 = round_half_up(roi[4], scale);
  const float rh = fmaxf(__fadd_rn(__fsub_rn(y2, y1), 1.f), 1.f);
  const float rw = fmaxf(__fadd_rn(__fsub_rn(x2, x1), 1.f), 1.f);
  const float bin_h = __fdiv_rn(rh, (float)ph);
  const float bin_w = __fdiv_rn(rw, (float)pw);
  for (int i = 0; i < ph; ++i) {
    o[1 + i] = clip_to(__fadd_rn(floorf(__fmul_rn((float)i, bin_h)), y1), H);
    o[1 + ph + i] =
        clip_to(__fadd_rn(ceilf(__fmul_rn((float)(i + 1), bin_h)), y1), H);
  }
  for (int j = 0; j < pw; ++j) {
    o[1 + 2 * ph + j] =
        clip_to(__fadd_rn(floorf(__fmul_rn((float)j, bin_w)), x1), W);
    o[1 + 2 * ph + pw + j] =
        clip_to(__fadd_rn(ceilf(__fmul_rn((float)(j + 1), bin_w)), x1), W);
  }
}

// xt[b, s, c] = x[b, c, s], s = h * W + w: a 32x32 tile through shared
// memory, both sides coalesced.
__global__ void to_channels_last_kernel(const float* __restrict__ x,
                                        float* __restrict__ xt, int C,
                                        int S) {
  __shared__ float tile[TR][TR + 1];
  const size_t img = (size_t)blockIdx.z * C * S;
  const int s0 = blockIdx.x * TR, c0 = blockIdx.y * TR;
  for (int k = threadIdx.y; k < TR; k += blockDim.y) {
    const int c = c0 + k, s = s0 + threadIdx.x;
    if (c < C && s < S) tile[k][threadIdx.x] = x[img + (size_t)c * S + s];
  }
  __syncthreads();
  for (int k = threadIdx.y; k < TR; k += blockDim.y) {
    const int s = s0 + k, c = c0 + threadIdx.x;
    if (c < C && s < S) xt[img + (size_t)s * C + c] = tile[threadIdx.x][k];
  }
}

// A bin's running maximum over one channel, m, with the pixels equal to
// it, n, and whether a pixel was NaN: updated pixel by pixel in row-major
// order, so the first of equal values stays.
struct BinStat {
  float m = -INFINITY;
  int n = 0;
  bool nan = false;
  __device__ __forceinline__ void add(float v) {
    if (v > m) {
      m = v;
      n = 1;
    } else if (v == m) {
      ++n;
    } else if (v != v) {
      nan = true;
    }
  }
  // 0 and 0 for an empty bin or a maximum that is not finite
  __device__ __forceinline__ void finish() {
    if (nan || !isfinite(m)) {
      m = 0.f;
      n = 0;
    }
  }
};

// The maximum of one channel over rows [hs, he) and columns [ws, we),
// `img` that channel of one image of xt; no count (K8).
__device__ __forceinline__ float bin_max(const float* __restrict__ img,
                                         int W, int C, int hs, int he,
                                         int ws, int we) {
  float m = -INFINITY;
  bool nan = false;
  for (int h = hs; h < he; ++h) {
    const float* row = img + (size_t)h * W * C;
#pragma unroll 8  // K8: a bin row's loads unrolled
    for (int w = ws; w < we; ++w) {
      const float v = __ldg(row + (size_t)w * C);
      m = v > m ? v : m;
      nan |= v != v;
    }
  }
  return nan || !isfinite(m) ? 0.f : m;
}

// The statistics of one bin of one channel (K8b): the window walked as
// one run of pixels in row-major order, SCAN loads issued before the
// first is compared.
__device__ __forceinline__ BinStat bin_stats(const float* __restrict__ img,
                                             int W, int C, int hs, int he,
                                             int ws, int we) {
  BinStat st;
  const int np = he > hs && we > ws ? (he - hs) * (we - ws) : 0;
  int h = hs, w = ws;
  for (int t0 = 0; t0 < np; t0 += SCAN) {
    float v[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      v[u] = t0 + u < np ? __ldg(img + ((size_t)h * W + w) * C) : 0.f;
      if (++w == we) {
        w = ws;
        ++h;
      }
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u)
      if (t0 + u < np) st.add(v[u]);
  }
  st.finish();
  return st;
}

// K8: out[r, c, i, j] = the bin's maximum over xt.  Block: (ROI, 32
// channels), FWD_WARPS warps sharing its bins, FWD_BINS at a time.
__global__ void __launch_bounds__(FWD_WARPS * 32)
roi_pool_fwd_kernel(const float* __restrict__ xt,
                    const int* __restrict__ bounds, float* __restrict__ out,
                    int C, int H, int W, int ph, int pw, int ctiles) {
  extern __shared__ float fsm[];  // [FWD_BINS][TPAD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x - r * ctiles) * CT;
  const bool active = c0 + lane < C;
  const int* o = bounds + (size_t)r * bounds_stride(ph, pw);
  const float* img = xt + (size_t)o[0] * H * W * C + c0 + lane;
  const int nb = ph * pw, nc = min(CT, C - c0);
  float* dst = out + ((size_t)r * C + c0) * nb;
  for (int k0 = 0; k0 < nb; k0 += FWD_BINS) {
    const int kn = min(FWD_BINS, nb - k0);
    for (int k = warp; k < kn; k += FWD_WARPS) {
      const int i = (k0 + k) / pw, j = k0 + k - i * pw;
      fsm[k * TPAD + lane] =
          active ? bin_max(img, W, C, o[1 + i], o[1 + ph + i],
                           o[1 + 2 * ph + j], o[1 + 2 * ph + pw + j])
                 : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nc * kn; e += FWD_WARPS * 32) {
      const int cc = e / kn, k = e - cc * kn;
      dst[(size_t)cc * nb + k0 + k] = fsm[k * TPAD + cc];
    }
    __syncthreads();
  }
}

// One 4-byte copy from device to shared memory that does not hold the
// thread (cp.async); cp_wait() waits for all of a thread's copies.
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// K8b's shared memory, in this order: the tile's map values (TH * TW
// pixels of 32 channels), partial sums when a ROI can take more than one
// step (`splits`), maxima and g-then-shares of a step's bins (CAP), the
// compacted ROI list and each entry's bin rows and columns meeting the
// tile (a block's worth of ROIs), warp counts, the step's items, state and
// bounds, then each item's row and column tables (bin ranges holding a
// pixel).
struct BwdSmem {
  size_t xs, part, bm, bs, list, ent, wcount, items, step, ibounds, rowtab,
      coltab, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int TH, int TW, int stride,
                                            bool splits) {
  BwdSmem s;
  const size_t tile = (size_t)TH * TW * TPAD * sizeof(float);
  const size_t bins = (size_t)CAP * TPAD * sizeof(float);
  s.xs = 0;
  s.part = s.xs + tile;
  s.bm = s.part + (splits ? tile : 0);
  s.bs = s.bm + bins;
  s.list = s.bs + bins;
  s.ent = s.list + (size_t)BWD_THREADS * sizeof(int);
  s.wcount = s.ent + 4 * (size_t)BWD_THREADS * sizeof(int);
  s.items = s.wcount + (BWD_WARPS + 1) * sizeof(int);
  s.step = s.items + 5 * GROUP * sizeof(int);
  s.ibounds = s.step + 4 * sizeof(int);
  s.rowtab = s.ibounds + (size_t)GROUP * stride * sizeof(int);
  s.coltab = s.rowtab + (size_t)GROUP * TH * sizeof(unsigned short);
  s.total = s.coltab + (size_t)GROUP * TW * sizeof(unsigned short);
  return s;
}

// A ROI can take more than one K8b step only if its bins can exceed CAP.
__host__ __device__ inline bool bwd_splits(int ph, int pw) {
  return ph * pw > CAP;
}

// K8b's tile of an H x W map: the full width when a block's pixels hold
// it, else runs of that many columns; as many rows as they hold.
inline void bwd_tile(int H, int W, int* TH, int* TW) {
  const int pixels = BWD_WARPS * PMAX;
  *TW = W < pixels ? W : pixels;
  *TH = H < pixels / *TW ? H : pixels / *TW;
}

// A bin range [lo_bin, hi_bin] packed as lo | hi << 8; an empty one is 1.
__device__ __forceinline__ unsigned short bin_range(const int* s,
                                                    const int* e, int a,
                                                    int z, int p) {
  int lo = a;
  while (lo < z && e[lo] <= p) ++lo;
  int hi = lo - 1;
  while (hi + 1 < z && s[hi + 1] <= p) ++hi;
  return lo <= hi ? (unsigned short)(lo | hi << 8) : (unsigned short)1;
}

// parts: 1 compacts the ROI lists (always), 2 runs the steps, 4 writes dx;
// 7 is the kernel.  Two blocks an SM cap it at 64 registers, with some
// spills: one block an SM, at 111 registers and no spills, took 5.82 ms
// at Faster R-CNN's size against 4.69 (NVIDIA H100 80GB HBM3, 700 W;
// chip_k8_costs.py).
__global__ void __launch_bounds__(BWD_THREADS, 2)
roi_pool_bwd_kernel(const float* __restrict__ xt,
                    const int* __restrict__ bounds,
                    const float* __restrict__ g, float* __restrict__ dx,
                    int R, int C, int H, int W, int ph, int pw, int TH,
                    int TW, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = bounds_stride(ph, pw);
  const BwdSmem L = bwd_smem(TH, TW, stride, bwd_splits(ph, pw));
  float* xs = (float*)(smem + L.xs);
  float* part = (float*)(smem + L.part);
  float* bm = (float*)(smem + L.bm);
  float* bs = (float*)(smem + L.bs);
  int* list = (int*)(smem + L.list);
  constexpr int nthr = BWD_THREADS, nw = BWD_WARPS;
  int* e_i0 = (int*)(smem + L.ent);
  int* e_i1 = e_i0 + nthr;
  int* e_j0 = e_i1 + nthr;
  int* e_j1 = e_j0 + nthr;
  int* wcount = (int*)(smem + L.wcount);
  int* it_e = (int*)(smem + L.items);
  int* it_i0 = it_e + GROUP;
  int* it_i1 = it_i0 + GROUP;
  int* it_off = it_i1 + GROUP;
  int* it_flag = it_off + GROUP;
  int* step = (int*)(smem + L.step);
  int* ib = (int*)(smem + L.ibounds);
  unsigned short* rowtab = (unsigned short*)(smem + L.rowtab);
  unsigned short* coltab = (unsigned short*)(smem + L.coltab);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CT;
  const bool active = c0 + lane < C;
  const int ntw = (W + TW - 1) / TW;
  const int lo = (blockIdx.y / ntw) * TH, hi = min(lo + TH, H);
  const int wlo = (blockIdx.y % ntw) * TW, whi = min(wlo + TW, W);
  const int b = blockIdx.z;
  const int tpix = TH * TW;
  const float* img = xt + (size_t)b * H * W * C + c0 + lane;

  // The tile's map values, 32 channels a pixel.
  for (int e = threadIdx.x; e < tpix * CT; e += nthr) {
    const int p = e / CT, cc = e - p * CT;
    const int h = lo + p / TW, w = wlo + p % TW;
    xs[p * TPAD + cc] =
        h < hi && w < whi && c0 + cc < C
            ? __ldg(xt + (((size_t)b * H + h) * W + w) * C + c0 + cc)
            : 0.f;
  }
  // This thread's pixels, p = warp + nw * s (row h, column w; -1 past the
  // tile), and their sums, in registers.
  int hw[PMAX];  // h << 16 | w, or -1
  float acc[PMAX];
#pragma unroll
  for (int s = 0; s < PMAX; ++s) {
    const int p = warp + nw * s;
    const int h = lo + p / TW, w = wlo + p % TW;
    hw[s] = p < tpix && h < hi && w < whi ? h << 16 | w : -1;
    acc[s] = 0.f;
  }

  for (int r0 = 0; r0 < R; r0 += nthr) {
    // The ROIs of [r0, r0 + nthr) meeting the tile, in ascending order,
    // with the bin rows [i0, i1) and columns [j0, j1) that meet it.
    const int r = r0 + threadIdx.x;
    bool meets = false;
    int i0 = 0, i1 = 0, j0 = 0, j1 = 0;
    if (r < R) {
      const int* o = bounds + (size_t)r * stride;
      const int* hs = o + 1;
      const int* he = hs + ph;
      const int* ws = he + ph;
      const int* we = ws + pw;
      meets = o[0] == b && hs[0] < hi && he[ph - 1] > lo && ws[0] < whi &&
              we[pw - 1] > wlo;
      if (meets) {
        while (he[i0] <= lo) ++i0;
        i1 = i0;
        while (i1 < ph && hs[i1] < hi) ++i1;
        while (we[j0] <= wlo) ++j0;
        j1 = j0;
        while (j1 < pw && ws[j1] < whi) ++j1;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n = 0;
    for (int k = 0; k < nw; ++k) {
      const int v = wcount[k];
      if (k < warp) base += v;
      n += v;
    }
    if (meets) {
      const int p = base + __popc(ballot & ((1u << lane) - 1u));
      list[p] = r;
      e_i0[p] = i0;
      e_i1[p] = i1;
      e_j0[p] = j0;
      e_j1[p] = j1;
    }
    if (threadIdx.x == 0) {
      step[2] = 0;   // next entry
      step[3] = -1;  // next bin row of an entry split over steps, or -1
    }
    __syncthreads();
    if (!(parts & 2)) continue;

    for (;;) {
      // The step: entries whose bins fit CAP, at most GROUP; or one
      // chunk of bin rows of an entry with more bins than CAP.
      if (threadIdx.x == 0) {
        int pos = step[2], row = step[3], ni = 0, nb = 0;
        if (pos < n) {
          const int nj = e_j1[pos] - e_j0[pos];
          const int a = e_i0[pos], z = e_i1[pos];
          if (row < 0 && (z - a) * nj > CAP) row = a;
          if (row >= 0) {
            const int zz = min(row + max(1, CAP / nj), z);
            it_e[0] = pos;
            it_i0[0] = row;
            it_i1[0] = zz;
            it_off[0] = 0;
            it_flag[0] = (row == a ? 1 : 0) | (zz == z ? 2 : 0);
            ni = 1;
            nb = (zz - row) * nj;
            if (zz == z) {
              ++pos;
              row = -1;
            } else {
              row = zz;
            }
          } else {
            while (pos < n && ni < GROUP) {
              const int bn =
                  (e_i1[pos] - e_i0[pos]) * (e_j1[pos] - e_j0[pos]);
              if (nb + bn > CAP) break;
              it_e[ni] = pos;
              it_i0[ni] = e_i0[pos];
              it_i1[ni] = e_i1[pos];
              it_off[ni] = nb;
              it_flag[ni] = 3;
              nb += bn;
              ++ni;
              ++pos;
            }
          }
        }
        step[0] = ni;
        step[1] = nb;
        step[2] = pos;
        step[3] = row;
      }
      __syncthreads();
      const int ni = step[0], nbins = step[1];
      if (ni == 0) break;

      // The items' bounds and their g, copied without holding a thread.
      for (int t = threadIdx.x; t < ni * stride; t += nthr) {
        const int q = t / stride;
        cp4(ib + t, bounds + (size_t)list[it_e[q]] * stride + t - q * stride);
      }
      for (int t = threadIdx.x; t < CT * nbins; t += nthr) {
        const int cc = t / nbins, k = t - cc * nbins;
        int q = 0;
        while (q + 1 < ni && it_off[q + 1] <= k) ++q;
        const int e = it_e[q], nj = e_j1[e] - e_j0[e], loc = k - it_off[q];
        const int i = it_i0[q] + loc / nj, j = e_j0[e] + loc % nj;
        if (c0 + cc < C)
          cp4(bs + k * TPAD + cc,
              g + (((size_t)list[e] * C + c0 + cc) * ph + i) * pw + j);
        else
          bs[k * TPAD + cc] = 0.f;
      }
      cp_wait();
      __syncthreads();

      // Each item's bin ranges by tile row and column; each bin's maximum
      // and tie count from xt and its share g / n.  A bin with no finite
      // maximum gets NaN, which no pixel equals.
      for (int t = threadIdx.x; t < ni * (TH + TW); t += nthr) {
        const int q = t / (TH + TW), u = t - q * (TH + TW);
        const int* o = ib + q * stride;
        if (u < TH) {
          rowtab[q * TH + u] =
              lo + u < hi ? bin_range(o + 1, o + 1 + ph, it_i0[q], it_i1[q],
                                      lo + u)
                          : (unsigned short)1;
        } else {
          const int v = u - TH, e = it_e[q];
          coltab[q * TW + v] =
              wlo + v < whi ? bin_range(o + 1 + 2 * ph, o + 1 + 2 * ph + pw,
                                        e_j0[e], e_j1[e], wlo + v)
                            : (unsigned short)1;
        }
      }
      for (int k = warp; k < nbins; k += nw) {
        int q = 0;
        while (q + 1 < ni && it_off[q + 1] <= k) ++q;
        const int e = it_e[q], nj = e_j1[e] - e_j0[e], loc = k - it_off[q];
        const int i = it_i0[q] + loc / nj, j = e_j0[e] + loc % nj;
        const int* o = ib + q * stride;
        BinStat st;
        if (active)
          st = bin_stats(img, W, C, o[1 + i], o[1 + ph + i],
                         o[1 + 2 * ph + j], o[1 + 2 * ph + pw + j]);
        bm[k * TPAD + lane] = st.n > 0 ? st.m : __int_as_float(0x7fc00000);
        if (st.n > 0)
          bs[k * TPAD + lane] = __fdiv_rn(bs[k * TPAD + lane], (float)st.n);
      }
      __syncthreads();

      // Each thread its own pixels, in registers: a pixel's bins in
      // ascending (i, j) make its share of the item's ROI, which its sum
      // takes item by item (a ROI split over steps keeps its partial share
      // in shared memory until its last step).
      for (int q = 0; q < ni; ++q) {
        const int e = it_e[q], flag = it_flag[q];
        const int* o = ib + q * stride;
        const int fr0 = o[1], fr1 = o[2 * ph];
        const int fc0 = o[1 + 2 * ph], fc1 = o[2 * ph + 2 * pw];
        const int qi0 = it_i0[q], qj0 = e_j0[e], nj = e_j1[e] - qj0;
        const int off = it_off[q];
#pragma unroll
        for (int s = 0; s < PMAX; ++s) {
          const int h = hw[s] >> 16, w = hw[s] & 0xffff;
          if (hw[s] < 0 || h < fr0 || h >= fr1 || w < fc0 || w >= fc1)
            continue;
          const int p = ((h - lo) * TW + w - wlo) * TPAD + lane;
          const unsigned rr = rowtab[q * TH + h - lo];
          const unsigned cr = coltab[q * TW + w - wlo];
          const int ja = cr & 255, je = cr >> 8;
          const float x = xs[p];
          float pt = (flag & 1) ? 0.f : part[p];
          for (int i = rr & 255; i <= (int)(rr >> 8); ++i) {
            const int row = off + (i - qi0) * nj - qj0;
            for (int j = ja; j <= je; ++j) {
              const int k = (row + j) * TPAD + lane;
              if (x == bm[k]) pt = __fadd_rn(pt, bs[k]);
            }
          }
          if (flag & 2)
            acc[s] = __fadd_rn(acc[s], pt);
          else
            part[p] = pt;
        }
      }
      __syncthreads();
    }
  }
  if (!(parts & 4)) return;
  // dx along w, through the map values' shared memory.
  __syncthreads();
#pragma unroll
  for (int s = 0; s < PMAX; ++s)
    if (hw[s] >= 0)
      xs[(((hw[s] >> 16) - lo) * TW + (hw[s] & 0xffff) - wlo) * TPAD +
         lane] = acc[s];
  __syncthreads();
  for (int t = threadIdx.x; t < CT * tpix; t += nthr) {
    const int cc = t / tpix, p = t - cc * tpix;
    const int h = lo + p / TW, w = wlo + p % TW;
    if (c0 + cc < C && h < hi && w < whi)
      dx[(((size_t)b * C + c0 + cc) * H + h) * W + w] = xs[p * TPAD + cc];
  }
}

bool bad_shape(int B, int C, int H, int W, int R, int ph, int pw) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || ph <= 0 ||
         pw <= 0 || ph > MAX_POOL || pw > MAX_POOL;
}

int ctiles_of(int C) { return (C + CT - 1) / CT; }

}  // namespace

// Bytes of the bounds array K8 writes and K8b reads for R ROIs.
extern "C" size_t mxtt_roi_pool_bounds_bytes(int R, int ph, int pw) {
  return (size_t)R * bounds_stride(ph, pw) * sizeof(int);
}

// K8.  data (B, C, H, W) and rois (R, 5) = [batch, x1, y1, x2, y2] f32,
// contiguous; writes xt (B, H, W, C), each ROI's bounds into `bounds`
// (mxtt_roi_pool_bounds_bytes) and out (R, C, ph, pw) f32.  `parts`: 1
// the channels-last copy, 2 the bounds, 4 the pooling (7 the kernel; the
// others time its parts apart).  Launches on `stream`; returns a CUDA
// error.
extern "C" int mxtt_roi_pool_fwd(const float* data, const float* rois,
                                 float* xt, int* bounds, float* out, int B,
                                 int C, int H, int W, int R, int ph, int pw,
                                 float scale, int parts, void* stream) {
  if (bad_shape(B, C, H, W, R, ph, pw) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long S = (long long)H * W;
  const long long blocks = (long long)R * ctiles_of(C);
  if (blocks > 0x7fffffffLL || (S + TR - 1) / TR > 0x7fffffffLL ||
      ctiles_of(C) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (parts & 1) {
    const dim3 grid((unsigned)((S + TR - 1) / TR), ctiles_of(C), B);
    to_channels_last_kernel<<<grid, dim3(TR, 8), 0, s>>>(data, xt, C,
                                                          (int)S);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (parts & 2) {
    roi_bounds_kernel<<<(R + NT - 1) / NT, NT, 0, s>>>(rois, R, B, H, W, ph,
                                                        pw, scale, bounds);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (parts & 4) {
    const size_t smem =
        (size_t)(ph * pw < FWD_BINS ? ph * pw : FWD_BINS) * TPAD *
        sizeof(float);
    const int err = (int)cudaFuncSetAttribute(
        roi_pool_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != 0) return err;
    roi_pool_fwd_kernel<<<(unsigned)blocks, FWD_WARPS * 32, smem, s>>>(
        xt, bounds, out, C, H, W, ph, pw, ctiles_of(C));
  }
  return (int)cudaGetLastError();
}

// K8b's tiling of an H x W map with ph x pw bins: plan[0..5] = rows and
// columns a tile, channels a tile, threads a block, ROIs and bins a step;
// returns the block's shared memory in bytes.
extern "C" size_t mxtt_roi_pool_bwd_plan(int H, int W, int ph, int pw,
                                         int* plan) {
  bwd_tile(H, W, &plan[0], &plan[1]);
  plan[2] = CT;
  plan[3] = BWD_THREADS;
  plan[4] = GROUP;
  plan[5] = CAP;
  return bwd_smem(plan[0], plan[1], bounds_stride(ph, pw),
                  bwd_splits(ph, pw))
      .total;
}

// K8b.  xt, bounds as K8 wrote them, g (R, C, ph, pw) the gradient of out;
// writes dx (B, C, H, W), a block a tile of mxtt_roi_pool_bwd_plan's and
// 32 channels.  `parts` as roi_pool_bwd_kernel's (7: the kernel).
// Launches on `stream`; returns a CUDA error.
extern "C" int mxtt_roi_pool_bwd(const float* xt, const int* bounds,
                                 const float* g, float* dx, int B, int C,
                                 int H, int W, int R, int ph, int pw,
                                 int parts, void* stream) {
  if (bad_shape(B, C, H, W, R, ph, pw) || B > 65535)
    return (int)cudaErrorInvalidValue;
  int TH, TW;
  bwd_tile(H, W, &TH, &TW);
  const long long tiles =
      (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const size_t smem =
      bwd_smem(TH, TW, bounds_stride(ph, pw), bwd_splits(ph, pw)).total;
  if (tiles > 65535 || ctiles_of(C) > 0x7fffffff || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      roi_pool_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  const dim3 grid(ctiles_of(C), (unsigned)tiles, B);
  roi_pool_bwd_kernel<<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
      xt, bounds, g, dx, R, C, H, W, ph, pw, TH, TW, parts);
  return (int)cudaGetLastError();
}
