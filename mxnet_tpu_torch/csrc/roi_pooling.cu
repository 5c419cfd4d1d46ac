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
// Design: K8 first runs a bounds kernel, one thread a ROI, that rounds the
// ROI onto the map and writes its batch index and the row and column
// extents of its bins into a small int32 array; the caller keeps that array
// for K8b, which reads it in place of the ROIs.
//
// K8 (forward) runs one thread an output element (r, c, i, j): it scans
// the bin's pixels and writes the maximum and the number of pixels equal
// to it (int32).  An empty bin, or one whose maximum is not finite (an
// infinite or NaN pixel), writes 0 and count 0, as the JAX function's
// `where(isfinite(out), out, 0)` does.
//
// K8b (backward) is a gather with no floating-point atomics: one thread an
// input element (b, c, h, w).  A block stages the bounds of CHUNK ROIs at a
// time in shared memory; each thread walks the ROIs in ascending order,
// skips those of another image or whose bins do not cover (h, w), and for
// the (at most four, since neighbouring bins share an edge row or column)
// bins that do, adds g / count where x equals the bin's maximum, summed per
// ROI and then into the pixel's total.  Dividing by the count is the JAX
// package's rule: `jnp.max`'s gradient splits a tie equally among the tied
// pixels (the MXNet reference gives all of it to its argmax).  Ties are
// routine here: ROIPooling reads a ReLU output, whose bins are often all 0.
// Each pixel's sum is taken in one fixed order, so two launches agree bit
// for bit.
//
// What bounds them: ROI pooling itself needs to read the map and the ROIs
// and write the maxima (205 MB at 2000 ROIs; the map, 4.7 MB, stays in
// L2), and its backward to read the map and g and write dx (210 MB).  This
// design moves more: K8 writes the counts beside the maxima (401 MB), and
// K8b reads out and count beside g (602 MB) while every thread tests every
// ROI of its image.  A simple, correct kernel first; making either fast
// is later work.
//
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

constexpr int NT = 256;     // threads a block, all three kernels
constexpr int CHUNK = 32;   // ROIs whose bounds K8b stages at a time
constexpr int MAX_POOL = 64;

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

// K8: out[r, c, i, j] = the bin's maximum, count[r, c, i, j] = the pixels
// equal to it; 0 and 0 for an empty bin or a maximum that is not finite.
__global__ void __launch_bounds__(NT)
roi_pool_fwd_kernel(const float* __restrict__ data,
                    const int* __restrict__ bounds, float* __restrict__ out,
                    int* __restrict__ count, int C, int H, int W, int ph,
                    int pw, long long total) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % pw);
  long long t = idx / pw;
  const int i = (int)(t % ph);
  t /= ph;
  const int c = (int)(t % C);
  const long long r = t / C;
  const int* o = bounds + r * bounds_stride(ph, pw);
  const int hs = o[1 + i], he = o[1 + ph + i];
  const int ws = o[1 + 2 * ph + j], we = o[1 + 2 * ph + pw + j];
  const float* img = data + ((size_t)o[0] * C + c) * (size_t)H * W;
  float m = -INFINITY;
  int n = 0;
  bool nan = false;
  for (int h = hs; h < he; ++h) {
    const float* row = img + (size_t)h * W;
    for (int w = ws; w < we; ++w) {
      const float v = __ldg(row + w);
      if (v > m) {
        m = v;
        n = 1;
      } else if (v == m) {
        ++n;
      } else if (v != v) {
        nan = true;
      }
    }
  }
  if (nan || !isfinite(m)) {
    m = 0.f;
    n = 0;
  }
  out[idx] = m;
  count[idx] = n;
}

// K8b: dx[b, c, h, w] = sum over the ROIs r of image b, in ascending order,
// of the sum over the bins (i, j) of r holding (h, w), in ascending order,
// of g / count where x == out (count > 0).
__global__ void __launch_bounds__(NT)
roi_pool_bwd_kernel(const float* __restrict__ data,
                    const int* __restrict__ bounds,
                    const float* __restrict__ out,
                    const int* __restrict__ count,
                    const float* __restrict__ g, float* __restrict__ dx,
                    int R, int C, int H, int W, int ph, int pw,
                    long long total) {
  extern __shared__ int sb[];
  const int stride = bounds_stride(ph, pw);
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  const bool valid = idx < total;
  const int w = valid ? (int)(idx % W) : 0;
  long long t = idx / W;
  const int h = valid ? (int)(t % H) : 0;
  t /= H;
  const int c = valid ? (int)(t % C) : 0;
  const int b = valid ? (int)(t / C) : -1;
  const float x = valid ? data[idx] : 0.f;
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += CHUNK) {
    const int nr = min(CHUNK, R - r0);
    __syncthreads();
    for (int k = threadIdx.x; k < nr * stride; k += NT)
      sb[k] = bounds[(size_t)r0 * stride + k];
    __syncthreads();
    for (int q = 0; q < nr; ++q) {
      const int* o = sb + q * stride;
      if (o[0] != b) continue;
      const int* hs = o + 1;
      const int* he = hs + ph;
      const int* ws = he + ph;
      const int* we = ws + pw;
      if (h < hs[0] || h >= he[ph - 1] || w < ws[0] || w >= we[pw - 1])
        continue;
      const size_t base = ((size_t)(r0 + q) * C + c) * ph;
      float part = 0.f;
      for (int i = 0; i < ph; ++i) {
        if (he[i] <= h) continue;
        if (hs[i] > h) break;
        for (int jj = 0; jj < pw; ++jj) {
          if (we[jj] <= w) continue;
          if (ws[jj] > w) break;
          const size_t k = (base + i) * pw + jj;
          if (x != out[k]) continue;
          const int n = count[k];  // 0: an empty bin or no finite maximum
          if (n > 0) part = __fadd_rn(part, __fdiv_rn(g[k], (float)n));
        }
      }
      acc = __fadd_rn(acc, part);
    }
  }
  if (valid) dx[idx] = acc;
}

bool bad_shape(int B, int C, int H, int W, int R, int ph, int pw) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || ph <= 0 ||
         pw <= 0 || ph > MAX_POOL || pw > MAX_POOL;
}

long long blocks_of(long long total) { return (total + NT - 1) / NT; }

}  // namespace

// Bytes of the bounds array K8 writes and K8b reads for R ROIs.
extern "C" size_t mxtt_roi_pool_bounds_bytes(int R, int ph, int pw) {
  return (size_t)R * bounds_stride(ph, pw) * sizeof(int);
}

// K8.  data (B, C, H, W) and rois (R, 5) = [batch, x1, y1, x2, y2] f32,
// contiguous; writes out (R, C, ph, pw) f32, count (R, C, ph, pw) int32 and
// each ROI's bounds into `bounds` (mxtt_roi_pool_bounds_bytes).  Launches on
// `stream`; returns a CUDA error.
extern "C" int mxtt_roi_pool_fwd(const float* data, const float* rois,
                                 float* out, int* count, int* bounds, int B,
                                 int C, int H, int W, int R, int ph, int pw,
                                 float scale, void* stream) {
  if (bad_shape(B, C, H, W, R, ph, pw)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)R * C * ph * pw;
  if (blocks_of(total) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  roi_bounds_kernel<<<(R + NT - 1) / NT, NT, 0, s>>>(rois, R, B, H, W, ph,
                                                      pw, scale, bounds);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  roi_pool_fwd_kernel<<<(unsigned)blocks_of(total), NT, 0, s>>>(
      data, bounds, out, count, C, H, W, ph, pw, total);
  return (int)cudaGetLastError();
}

// K8b.  data as K8's; bounds, out and count K8's, g (R, C, ph, pw) the
// gradient of out; writes dx (B, C, H, W).  Launches on `stream`; returns
// a CUDA error.
extern "C" int mxtt_roi_pool_bwd(const float* data, const int* bounds,
                                 const float* out, const int* count,
                                 const float* g, float* dx, int B, int C,
                                 int H, int W, int R, int ph, int pw,
                                 void* stream) {
  if (bad_shape(B, C, H, W, R, ph, pw)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * C * H * W;
  if (blocks_of(total) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)CHUNK * bounds_stride(ph, pw) * sizeof(int);
  roi_pool_bwd_kernel<<<(unsigned)blocks_of(total), NT, smem, s>>>(
      data, bounds, out, count, g, dx, R, C, H, W, ph, pw, total);
  return (int)cudaGetLastError();
}
