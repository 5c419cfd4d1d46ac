// Kernel K7: greedy non-maximum suppression over the boxes of each image,
// in score order, for _contrib_MultiBoxDetection.
//
// Replaces no Pallas kernel.  The JAX package runs greedy NMS as plain JAX
// (mxnet_tpu/ops/contrib.py:243 `_greedy_nms`): a `lax.fori_loop` over the
// A boxes of an image in visit order, each step suppressing the later boxes
// whose IoU with the visited box is at least the threshold (the IoU matrix
// up to NMS_MATRIX_MAX_BOXES = 2048 boxes, its rows on the fly above).  In
// eager PyTorch that loop is ~10 launches a step: for SSD300's A = 7308
// anchors, ~70,000 launches a batch, and the A x A matrix is 214 MB an
// image.
//
// Design: one thread block per image.  The visit order and the class ids
// in visit order sit in shared memory with one "still kept" byte per visit
// position (9 bytes a box: 66 KB at A = 7308).  For each visited position i
// whose box is still kept and valid (class id >= 0), the block's threads
// test every later position in parallel, computing the IoU on the fly from
// the boxes in device memory (L1/L2-resident: 117 KB an image), then meet
// at a barrier.  A position that is suppressed or invalid is skipped
// without a barrier: the flags it reads were settled by the barrier after
// the last pass that wrote any.
//
// What bounds it: the serial chain of passes, one barrier each, not bytes
// (each image reads its boxes, ids and order once and writes A flags) nor
// operations (at most A^2 / 2 IoUs an image).
//
// Numerics: the IoU is computed in `_iou_matrix`'s order
// (mxnet_tpu/ops/contrib.py:39-54), every operation rounded on its own
// (__fmul_rn etc.: no FMA contraction), so `iou >= threshold` flips at the
// same ulp as the plain version and the JAX function.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ float clip0(float v) { return v < 0.f ? 0.f : v; }

// IoU of visited box a against box b, in _iou_matrix's order.
__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  const float ix1 = fmaxf(a.x, b.x), iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z), iy2 = fminf(a.w, b.w);
  const float inter =
      __fmul_rn(clip0(__fsub_rn(ix2, ix1)), clip0(__fsub_rn(iy2, iy1)));
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// Shared memory: order (int A), class ids in visit order (float A), then
// one flag byte a visit position.
__global__ void __launch_bounds__(NT)
    nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ cls,
               const int* __restrict__ order, uint8_t* __restrict__ keep,
               int A, float thresh, int force) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_order = reinterpret_cast<int*>(smem);
  float* s_cls = reinterpret_cast<float*>(s_order + A);
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_cls + A);
  const size_t base = (size_t)blockIdx.x * A;
  boxes += base;
  cls += base;
  order += base;
  keep += base;
  for (int p = threadIdx.x; p < A; p += NT) {
    const int k = order[p];
    s_order[p] = k;
    s_cls[p] = cls[k];
    s_flag[p] = 1;
  }
  __syncthreads();
  for (int i = 0; i < A - 1; ++i) {
    const float cj = s_cls[i];
    // uniform across the block: no thread skips a barrier another meets
    if (!s_flag[i] || !(cj >= 0.f)) continue;
    const float4 bj = boxes[s_order[i]];
    for (int p = i + 1 + threadIdx.x; p < A; p += NT) {
      const float ck = s_cls[p];
      if (!s_flag[p] || !(ck >= 0.f) || (!force && ck != cj)) continue;
      if (iou_rn(bj, boxes[s_order[p]]) >= thresh) s_flag[p] = 0;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < A; p += NT) keep[s_order[p]] = s_flag[p];
}

size_t smem_bytes(int A) { return (size_t)A * 9; }

}  // namespace

// The most boxes an image may have on the current device (its shared
// memory a block may opt into), or -1 on a CUDA error.
extern "C" int mxtt_nms_max_boxes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin / 9;
}

// keep[b, k] = 1 where box k of image b survives greedy NMS in the visit
// order order[b, :] (a permutation of 0..A-1), else 0.  boxes (B, A, 4)
// corners, cls (B, A) class ids (< 0: invalid, never kept by NMS's
// caller and never suppressing), thresh the IoU at or above which a later
// box is suppressed, force: suppress across classes.  Launches on
// `stream`; returns a CUDA error.
extern "C" int mxtt_nms(const float* boxes, const float* cls, const int* order,
                        unsigned char* keep, int B, int A, float thresh,
                        int force, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(A);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), cls, order,
      reinterpret_cast<uint8_t*>(keep), A, thresh, force);
  return (int)cudaGetLastError();
}
