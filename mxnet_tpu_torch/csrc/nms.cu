// Kernel K7: greedy non-maximum suppression over the boxes of each image,
// in score order, for _contrib_MultiBoxDetection.
//
// Replaces no Pallas kernel.  The JAX package runs greedy NMS as plain JAX
// (mxnet_tpu/ops/contrib.py:243 `_greedy_nms`): a `lax.fori_loop` over the
// A boxes of an image in visit order, each step suppressing the later boxes
// whose IoU with the visited box is at least the threshold (the IoU matrix
// up to NMS_MATRIX_MAX_BOXES = 2048 boxes, its rows on the fly above).  In
// eager PyTorch that loop is ~10 launches a step: for SSD300's A = 7308
// anchors, ~70,000 launches a batch.
//
// Design: three kernels in one call, on the caller's stream.
//
// 1. The mask pass spreads the pair tests over the whole card.  A gather
//    kernel puts each image's boxes in visit order with their areas and
//    class keys, one word of valid flags for each 64-position chunk, and
//    the number of chunks up to the last valid box.  Then one 64-thread
//    block takes each (image, row chunk r, GROUP column chunks c >= r): it
//    stages a column chunk in shared memory (the next one loading
//    meanwhile), and each thread writes, for its row position i and each
//    column chunk, one 64-bit word whose bit t says that box i, if kept,
//    suppresses position 64c + t: 64c + t > i, both boxes valid (class id
//    >= 0), the classes equal or `force`, and IoU >= thresh.  Only the
//    words at or right of a row's own chunk are stored (the mask is a
//    triangle of chunks); blocks past the last valid chunk, or whose row
//    chunk holds no valid box, exit at once.
// 2. The scan runs one block per image.  It walks the chunks TILE at a
//    time, keeping one "removed" word a chunk in shared memory.  One warp
//    resolves a tile's 64 * TILE decisions from the tile's own diagonal
//    words (staged in shared memory), a chunk at a time, with no barrier:
//    the chunk's kept set is the fixed point of "candidates not hit by a
//    kept row", reached in as many warp-wide OR rounds as the longest
//    chain of suppressions in the chunk, plus one.  Then the block ORs
//    the kept rows' later words into "removed" and writes the tile's
//    keep flags.  The next tile's diagonal words are loaded into
//    registers while the block ORs, so a tile step costs about one round
//    trip to memory and the serial chain is ~A / 512 steps an image.
//
// What bounds it: the mask pass does all V^2 / 2 pair tests of an image's
// V valid boxes (the greedy loop needs only the kept boxes' rows), and the
// issue rate of those tests bounds it; the scan's chain of tile steps is
// latency.
//
// Numerics: the IoU is computed in `_iou_matrix`'s order
// (mxnet_tpu/ops/contrib.py:39-54), every operation rounded on its own
// (__fmul_rn etc.: no FMA contraction), so `iou >= threshold` flips at the
// same ulp as the plain version and the JAX function.  The mask pass
// decides most pairs without the division, exactly: the sign of one fused
// multiply-add, inter - thresh * union, is the sign of the exact
// difference, and the rounded quotient is compared only where it rounds
// at the threshold.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int CHUNK = 64;           // visit positions a mask word covers
constexpr int TILE = 8;             // chunks the scan resolves a step
constexpr int SCAN_NT = TILE * CHUNK;  // one scan thread a tile position
constexpr int DIAG = TILE * CHUNK * TILE;  // a tile's diagonal words, padded
constexpr int PRE = DIAG / SCAN_NT;
constexpr int UNROLL = 8;           // independent loads a scan thread issues
constexpr int GROUP = 2;            // column chunks a mask block tests
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Mask words before row chunk r's: its rows hold nC - r words each, word
// c - r for column chunk c.
__host__ __device__ __forceinline__ size_t chunk_base(int r, int nC) {
  return (size_t)CHUNK * ((size_t)r * (2 * (size_t)nC - r + 1) / 2);
}

__host__ __device__ __forceinline__ size_t mask_words(int nC) {
  return chunk_base(nC, nC);
}

// IoU of visited box a against box b, in _iou_matrix's order.
__device__ __forceinline__ float iou_rn(float4 a, float4 b) {
  const float ix1 = fmaxf(a.x, b.x), iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z), iy2 = fminf(a.w, b.w);
  const float sx = __fsub_rn(ix2, ix1), sy = __fsub_rn(iy2, iy1);
  const float inter = __fmul_rn(sx < 0.f ? 0.f : sx, sy < 0.f ? 0.f : sy);
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// The boxes in visit order, each chunk padded to 64 positions: corners,
// (area, key) with the key NaN for an invalid box (it equals no key), else
// the class id, or 0 under `force`; the chunks' valid words; the number of
// chunks up to the last that holds a valid box (zeroed before).
__global__ void __launch_bounds__(CHUNK)
    nms_prep_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ cls,
                    const int* __restrict__ order, float4* __restrict__ sbox,
                    float2* __restrict__ sak, u64* __restrict__ valid_words,
                    int* __restrict__ nvc, int A, int nC, int force) {
  const int c = blockIdx.x, t = threadIdx.x, p = c * CHUNK + t;
  const size_t img = (size_t)blockIdx.y * A;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  float key = __int_as_float(0x7fffffff);
  bool valid = false;
  if (p < A) {
    const int k = order[img + p];
    const float cl = cls[img + k];
    b = boxes[img + k];
    valid = cl >= 0.f;
    if (valid) key = force ? 0.f : cl;
  }
  const size_t q = (size_t)blockIdx.y * nC * CHUNK + p;
  sbox[q] = b;
  sak[q] = make_float2(box_area(b), key);
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if ((t & 31) == 0)
    reinterpret_cast<unsigned*>(valid_words)[2 * ((size_t)blockIdx.y * nC +
                                                  c) + (t >> 5)] = ballot;
  if (__syncthreads_or(valid) && t == 0) atomicMax(nvc + blockIdx.y, c + 1);
}

// An invalid box (key NaN), or one of finite area > 0 (so finite
// corners): what the mask pass's fast test takes.
__device__ __forceinline__ bool tame(float2 area_key) {
  return area_key.y != area_key.y ||
         (area_key.x > 0.f && area_key.x <= 3.402823466e38f);
}

__global__ void __launch_bounds__(CHUNK)
    nms_mask_kernel(const float4* __restrict__ sbox,
                    const float2* __restrict__ sak,
                    const u64* __restrict__ valid_words,
                    const int* __restrict__ nvc, u64* __restrict__ mask,
                    int nC, float thresh, float thresh_lo) {
  __shared__ float4 s_box[CHUNK];
  __shared__ float2 s_ak[CHUNK];
  const int r = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  // column chunks GROUP * blockIdx.x on, at or right of r; past the last
  // valid chunk the scan reads nothing, nor a row chunk with no valid box
  if ((int)blockIdx.x * GROUP + GROUP <= r) return;
  const int c_begin = max(r, (int)blockIdx.x * GROUP);
  const int c_end = min((int)blockIdx.x * GROUP + GROUP, nvc[b]);
  if (c_begin >= c_end) return;
  valid_words += (size_t)b * nC;
  const u64 vr = valid_words[r];
  if (!vr) return;
  const size_t img = (size_t)b * nC * CHUNK;
  sbox += img;
  sak += img;
  mask += (size_t)b * mask_words(nC) + chunk_base(r, nC) +
          (size_t)t * (nC - r) - r;
  const float4 a = sbox[(size_t)r * CHUNK + t];
  const float2 ak = sak[(size_t)r * CHUNK + t];
  const bool row_valid = (vr >> t) & 1, row_tame = tame(ak);
  // the next column chunk is loaded while this one is tested
  float4 nb = sbox[(size_t)c_begin * CHUNK + t];
  float2 nk = sak[(size_t)c_begin * CHUNK + t];
  u64 nv = valid_words[c_begin];
  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();  // the last chunk's readers are done
    s_box[t] = nb;
    s_ak[t] = nk;
    const bool any_col = nv != 0;
    const bool col_tame = tame(nk);
    if (c + 1 < c_end) {
      nb = sbox[(size_t)(c + 1) * CHUNK + t];
      nk = sak[(size_t)(c + 1) * CHUNK + t];
      nv = valid_words[c + 1];
    }
    const bool all_tame = __syncthreads_and(col_tame && row_tame);
    u64 bits = 0;
    if (any_col && row_valid && all_tame) {
      // Both boxes of every pair here have a finite area > 0, so the
      // union is > 0 (the clipped intersection is at most the smaller
      // area), and the sign of one fused multiply-add is the exact sign
      // of inter - u * union: above 0 at u = thresh means the rounded IoU
      // is >= thresh, below 0 at u = thresh_lo (thresh's predecessor)
      // that it is < thresh; in between (rounding at the threshold, or a
      // product that underflowed) the quotient decides, as iou_rn rounds
      // it, after the loop.
      u64 unsure = 0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4 bj = s_box[j];
        const float2 bk = s_ak[j];
        const float w = __fsub_rn(fminf(a.z, bj.z), fmaxf(a.x, bj.x));
        const float h = __fsub_rn(fminf(a.w, bj.w), fmaxf(a.y, bj.y));
        const float inter = __fmul_rn(fmaxf(w, 0.f), fmaxf(h, 0.f));
        const float uni = __fsub_rn(__fadd_rn(ak.x, bk.x), inter);
        const float above = __fmaf_rn(-thresh, uni, inter);
        const float below = __fmaf_rn(-thresh_lo, uni, inter);
        const bool same = bk.y == ak.y;
        if (same && above > 0.f) bits |= 1ull << j;
        if (same && !(above > 0.f) && !(below < 0.f)) unsure |= 1ull << j;
      }
      while (unsure) {
        const int j = __ffsll((long long)unsure) - 1;
        if (iou_rn(a, s_box[j]) >= thresh) bits |= 1ull << j;
        unsure &= unsure - 1;
      }
    } else if (any_col && row_valid) {
      for (int j = 0; j < CHUNK; ++j)
        if (s_ak[j].y == ak.y && iou_rn(a, s_box[j]) >= thresh)
          bits |= 1ull << j;
    }
    if (c == r) bits &= t == CHUNK - 1 ? 0ull : ~0ull << (t + 1);
    mask[c] = bits;
  }
}

// The OR of v over the 32 lanes of a warp.
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  return (u64)hi << 32 | lo;
}

// Lane l's share of the OR over the rows set in `rows`: its words for
// rows l and l + 32.
__device__ __forceinline__ u64 pick(u64 rows, int l, u64 w_lo, u64 w_hi) {
  return ((rows >> l) & 1 ? w_lo : 0) | ((rows >> (l + 32)) & 1 ? w_hi : 0);
}

// Entry e of a tile's diagonal block: row e / TILE of the tile (chunk j =
// row / CHUNK), word e % TILE of that row counted from its own chunk; only
// words inside the tile (e % TILE < nt - j) are loaded.
__device__ __forceinline__ void fetch_diag(u64 (&pre)[PRE], u64& pre_valid,
                                           const u64* mask,
                                           const u64* valid_words, int c0,
                                           int nvc, int nC) {
  const int nt = min(TILE, nvc - c0);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int e = threadIdx.x + i * SCAN_NT;
    const int row = e / TILE, jj = e % TILE, j = row / CHUNK;
    pre[i] = 0;
    if (jj < nt - j) {
      const int rc = c0 + j;
      pre[i] = mask[chunk_base(rc, nC) + (size_t)(row % CHUNK) * (nC - rc) +
                    jj];
    }
  }
  pre_valid = threadIdx.x < nt ? valid_words[c0 + threadIdx.x] : 0;
}

__global__ void __launch_bounds__(SCAN_NT)
    nms_scan_kernel(const int* __restrict__ order,
                    const u64* __restrict__ mask,
                    const u64* __restrict__ valid_words,
                    const int* __restrict__ nvc_of,
                    uint8_t* __restrict__ keep, int A, int nC) {
  extern __shared__ u64 s_removed[];  // one word a chunk
  __shared__ u64 s_diag[DIAG];
  __shared__ u64 s_valid[TILE];
  __shared__ u64 s_keepw[TILE];      // kept or invalid: keep flag 1
  __shared__ int s_rows[SCAN_NT];    // the tile's kept rows, tile-local
  __shared__ int s_nkept;
  const int tid = threadIdx.x;
  const int nvc = nvc_of[blockIdx.x];  // chunks up to the last valid box
  mask += (size_t)blockIdx.x * mask_words(nC);
  valid_words += (size_t)blockIdx.x * nC;
  order += (size_t)blockIdx.x * A;
  keep += (size_t)blockIdx.x * A;

  for (int c = tid; c < nvc; c += SCAN_NT) s_removed[c] = 0;
  // past those chunks every box is invalid: kept, suppressing nothing
  for (int p = nvc * CHUNK + tid; p < A; p += SCAN_NT) keep[order[p]] = 1;

  u64 pre[PRE], pre_valid = 0;
  if (nvc > 0) fetch_diag(pre, pre_valid, mask, valid_words, 0, nvc, nC);
  for (int c0 = 0; c0 < nvc; c0 += TILE) {
    const int nt = min(TILE, nvc - c0);
#pragma unroll
    for (int i = 0; i < PRE; ++i) s_diag[tid + i * SCAN_NT] = pre[i];
    if (tid < TILE) s_valid[tid] = pre_valid;
    const int p = c0 * CHUNK + tid;
    const int k = p < A ? order[p] : 0;
    __syncthreads();
    if (tid < 32) {
      // warp 0 resolves the tile, chunk by chunk; lane l holds rows l and
      // l + 32 of the chunk, every other value is the same in all lanes
      const int l = tid;
      u64 rem[TILE];
      int nk = 0;
#pragma unroll
      for (int j = 0; j < TILE; ++j) rem[j] = j < nt ? s_removed[c0 + j] : 0;
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        const u64 valid = s_valid[j], cand = valid & ~rem[j];
        const int lo = (j * CHUNK + l) * TILE, hi = lo + 32 * TILE;
        const u64 d_lo = s_diag[lo], d_hi = s_diag[hi];
        // the kept set K is the one fixed point of K = cand & ~(OR of the
        // words of K's rows): a row's word has bits only past the row, so
        // iterating from K = cand settles each position once every
        // earlier one has, within 64 rounds, and a round that changes
        // nothing has reached it
        u64 kept = cand;
        for (;;) {
          const u64 next = cand & ~warp_or(pick(kept, l, d_lo, d_hi));
          if (next == kept) break;
          kept = next;
        }
#pragma unroll
        for (int jj = j + 1; jj < TILE; ++jj)
          rem[jj] |= warp_or(pick(kept, l, s_diag[lo + jj - j],
                                  s_diag[hi + jj - j]));
        if ((kept >> l) & 1)
          s_rows[nk + __popcll(kept & ((1ull << l) - 1))] = j * CHUNK + l;
        if ((kept >> (l + 32)) & 1)
          s_rows[nk + __popcll(kept & ((1ull << (l + 32)) - 1))] =
              j * CHUNK + 32 + l;
        nk += __popcll(kept);
        if (l == 0) s_keepw[j] = kept | ~valid;
      }
      if (l == 0) s_nkept = nk;
    }
    __syncthreads();
    if (p < A && tid < nt * CHUNK)
      keep[k] = (uint8_t)((s_keepw[tid / CHUNK] >> (tid % CHUNK)) & 1);
    if (c0 + TILE < nvc)
      fetch_diag(pre, pre_valid, mask, valid_words, c0 + TILE, nvc, nC);
    // the kept rows' words right of the tile, one (row, word) an item
    const int nw = nvc - c0 - nt, items = s_nkept * nw;
    for (int e0 = tid; e0 < items; e0 += SCAN_NT * UNROLL) {
      u64 v[UNROLL];
      int w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * SCAN_NT;
        v[u] = 0;
        w[u] = 0;
        if (e < items) {
          const int row = s_rows[e / nw], rc = c0 + row / CHUNK;
          w[u] = c0 + nt + e % nw;
          v[u] = mask[chunk_base(rc, nC) + (size_t)(row % CHUNK) * (nC - rc) +
                      (w[u] - rc)];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (v[u]) atomicOr(&s_removed[w[u]], v[u]);
    }
  }
}

size_t scan_smem(int nC) { return (size_t)nC * sizeof(u64); }

// The workspace of B images of A boxes (nC chunks), in 8-byte words (from
// a 16-byte aligned base): the boxes in visit order (two words a position)
// and their (area, key) (one word), each image's triangle of mask words,
// its valid words, then one int an image, the chunks up to its last valid
// box.
size_t work_words(int B, int nC) {
  return (size_t)B * (3 * (size_t)nC * CHUNK + mask_words(nC) + nC) +
         ((size_t)B + 1) / 2;
}

struct Work {
  float4* sbox;
  float2* sak;
  u64 *mask, *valid;
  int* nvc;
  Work(void* base, int B, int nC) {
    const size_t pos = (size_t)nC * CHUNK;
    sbox = static_cast<float4*>(base);
    sak = reinterpret_cast<float2*>(sbox + (size_t)B * pos);
    mask = reinterpret_cast<u64*>(sak + (size_t)B * pos);
    valid = mask + (size_t)B * mask_words(nC);
    nvc = reinterpret_cast<int*>(valid + (size_t)B * nC);
  }
};

}  // namespace

// Bytes of the workspace `mxtt_nms` takes for B images of A boxes.
extern "C" size_t mxtt_nms_workspace_bytes(int B, int A) {
  return work_words(B, (A + CHUNK - 1) / CHUNK) * sizeof(u64);
}

// keep[b, k] = 1 where box k of image b survives greedy NMS in the visit
// order order[b, :] (a permutation of 0..A-1), else 0.  boxes (B, A, 4)
// corners, cls (B, A) class ids (< 0: invalid, never kept by NMS's
// caller and never suppressing), thresh > 0 the IoU at or above which a
// later box is suppressed, force: suppress across classes.  `work` holds
// mxtt_nms_workspace_bytes(B, A) bytes, 16-byte aligned.  parts: 1 the mask pass (the
// gather into visit order, then the mask), 2 the scan (over what a mask
// pass left in `work`), 3 both.  Launches on
// `stream`; returns a CUDA error.
extern "C" int mxtt_nms(const float* boxes, const float* cls, const int* order,
                        unsigned char* keep, void* work, size_t work_bytes,
                        int B, int A, float thresh, int force, int parts,
                        void* stream) {
  if (B <= 0 || A <= 0 || !(thresh > 0.f) || parts < 1 || parts > 3)
    return (int)cudaErrorInvalidValue;
  const int nC = (A + CHUNK - 1) / CHUNK;
  if (nC > MAX_GRID_Y || work_bytes < work_words(B, nC) * sizeof(u64))
    return (int)cudaErrorInvalidValue;
  const Work ws(work, B, nC);
  cudaStream_t s = (cudaStream_t)stream;
  if (parts & 1) {
    cudaError_t err =
        cudaMemsetAsync(ws.nvc, 0, (size_t)B * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const float thresh_lo = nextafterf(thresh, 0.f);
    for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
      const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
      const size_t pos = (size_t)b0 * nC * CHUNK;
      nms_prep_kernel<<<dim3(nC, nb), CHUNK, 0, s>>>(
          reinterpret_cast<const float4*>(boxes) + (size_t)b0 * A,
          cls + (size_t)b0 * A, order + (size_t)b0 * A, ws.sbox + pos,
          ws.sak + pos, ws.valid + (size_t)b0 * nC, ws.nvc + b0, A, nC,
          force);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      nms_mask_kernel<<<dim3((nC + GROUP - 1) / GROUP, nC, nb), CHUNK, 0,
                        s>>>(ws.sbox + pos, ws.sak + pos,
                             ws.valid + (size_t)b0 * nC, ws.nvc + b0,
                             ws.mask + (size_t)b0 * mask_words(nC), nC,
                             thresh, thresh_lo);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (parts & 2) {
    const size_t smem = scan_smem(nC);
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nms_scan_kernel);
    if (err != cudaSuccess) return (int)err;
    if (smem + attr.sharedSizeBytes > (size_t)optin)
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    nms_scan_kernel<<<B, SCAN_NT, smem, s>>>(order, ws.mask, ws.valid,
                                             ws.nvc,
                                             reinterpret_cast<uint8_t*>(keep),
                                             A, nC);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}
