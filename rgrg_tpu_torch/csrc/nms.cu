// Greedy non-maximum suppression keep mask, one thread block per image.
//
// Replaces: rgrg_tpu/ops/nms_pallas.py `_nms_kernel` (entry
// `nms_keep_mask_pallas`), the TPU kernel that resolves greedy NMS over
// score-sorted proposals with a per-tile fixpoint plus one [T, N] masked max.
//
// What bounds it on the H100: not bytes and not FLOPs. An image moves
// 18 bytes per box (16 in, 1 valid, 1 keep) and the IoU tests of 1000 boxes
// are a few MFLOP, both well under a microsecond. Greedy NMS is a chain of
// N dependent decisions, so the bound is the latency of that chain: one
// block-wide barrier per KEPT box.
//
// Design: all N boxes of an image (N <= 2048, 32 KB) and their keep flags
// sit in shared memory. The block walks boxes in score order; when box i is
// still kept, every thread tests its own later boxes j against i and clears
// their flags, then the block synchronises. Suppressed boxes cost no
// barrier. B images run as B independent blocks in one launch.
//
// Exactness: the keep mask must equal the f32 reference bit for bit, so the
// IoU uses the reference's formula and operation order,
//   inter / ((area_a + area_b) - inter),
// with round-to-nearest intrinsics and no epsilon; the file is also built
// with -fmad=false. A contracted `area_a + area_b - inter` would flip
// decisions at IoU ~ 0.7. Zero-area pairs give 0/0 = NaN, and NaN > t is
// false, so they never suppress. Boxes with valid == 0 start unkept: they
// are never kept and never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 2048;
constexpr int kThreads = 256;

__device__ __forceinline__ bool suppresses(float ax1, float ay1, float ax2,
                                           float ay2, float bx1, float by1,
                                           float bx2, float by2, float thr) {
  const float area_a = __fmul_rn(__fsub_rn(ax2, ax1), __fsub_rn(ay2, ay1));
  const float area_b = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
  const float x1 = fmaxf(ax1, bx1);
  const float y1 = fmaxf(ay1, by1);
  const float x2 = fminf(ax2, bx2);
  const float y2 = fminf(ay2, by2);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                                fmaxf(__fsub_rn(y2, y1), 0.0f));
  const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
  return iou > thr;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int n, float thr) {
  __shared__ float sx1[kMaxBoxes], sy1[kMaxBoxes], sx2[kMaxBoxes], sy2[kMaxBoxes];
  __shared__ uint8_t sk[kMaxBoxes];

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* b = boxes + (base + j) * 4;
    sx1[j] = b[0];
    sy1[j] = b[1];
    sx2[j] = b[2];
    sy2[j] = b[3];
    sk[j] = valid[base + j] ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // sk[i] is final here: only flags j > i are written in step i, and the
    // writes of the last taken step were fenced by its barrier, so every
    // thread reads the same value and takes the same branch.
    if (sk[i]) {
      const float ax1 = sx1[i], ay1 = sy1[i], ax2 = sx2[i], ay2 = sy2[i];
      for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
        if (sk[j] && suppresses(ax1, ay1, ax2, ay2, sx1[j], sy1[j], sx2[j],
                                sy2[j], thr)) {
          sk[j] = 0;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x) keep[base + j] = sk[j];
}

}  // namespace

// boxes [batch, n, 4] f32, valid/keep [batch, n] bool (1 byte), contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rgrg_nms_keep_mask(const void* boxes, const void* valid,
                                  void* keep, int batch, int n, float thr,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxBoxes) return cudaErrorInvalidValue;
  nms_keep_mask_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
