// RoIAlign (aligned=False) over the C5 map, NHWC, f32 output.
//
// Replaces: rgrg_tpu/ops/roi_align_pallas.py `_roi_align_kernel` and its
// batched grid wrapper `_batched_kernel` (entries `roi_align_pallas_batched`
// and `roi_align_pallas`): per-ROI separable interpolation weights
// Ay [P, H] and Ax [P, W] (`_axis_weights_block`), then two contractions,
// out[p, q, c] = sum_h Ay[p, h] * sum_w Ax[q, w] * F[h, w, c].
//
// What bounds it on the H100: the store. At the serving shape (B=8, 256
// ROIs per chunk, C=2048, 16x16 map, 8x8 bins) the f32 output is 1.07 GB,
// ~0.32 ms at 3.35 TB/s. The function itself needs few operations: a bin
// touches at most 4 rows x 4 columns of the map, so at most 2048 FLOP per
// (ROI, channel), <= 8.6 GFLOP, <= 0.13 ms at the 67 TFLOP/s f32
// (non-tensor) peak. The feature map (2 or 4 MB per image) stays in L2.
// This kernel still runs the dense separable contraction, 6144 FLOP per
// (ROI, channel), 25.8 GFLOP, ~0.39 ms of f32 issue: more than the store,
// so skipping zero taps comes before any work on the store.
//
// Design: one block per (channel tile of 128, block of 8 ROIs, image). The
// block first builds the 8 ROIs' Ay/Ax rows in shared memory (8 KB), one
// row per thread, with the same float operations as `_axis_weights_block`
// (round-to-nearest intrinsics, so no FMA reorders them). Then each thread
// owns one channel: per ROI it streams the 16 map rows, contracts each row
// with Ax into 8 values and accumulates Ay-weighted 8x8 outputs in
// registers. Threads run along C, so every feature read and output write of
// a warp is 32 consecutive channels (coalesced). Accumulation is f32 for
// f32 and bf16 features alike. Later PRs can skip the zero taps and stage
// output through TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kRois = 8;       // ROIs per block
constexpr int kP = 8;          // output bins per axis
constexpr int kExtent = 16;    // feature map height == width
constexpr int kSampling = 2;   // samples per bin edge

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One row of `_axis_weights_block`: weights of output bin p over the
// `kExtent` map cells along one axis, for a ROI starting at `start` with
// bins of `bin` cells.
__device__ void axis_weights_row(float start, float bin, int p, float* row) {
  float acc[kExtent];
#pragma unroll
  for (int g = 0; g < kExtent; ++g) acc[g] = 0.0f;
  const float extent = static_cast<float>(kExtent);
#pragma unroll
  for (int s = 0; s < kSampling; ++s) {
    // y = start + p * b + (s + 0.5) * b / S
    const float y = __fadd_rn(
        __fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
        __fdiv_rn(__fmul_rn(static_cast<float>(s) + 0.5f, bin),
                  static_cast<float>(kSampling)));
    const float valid = (y >= -1.0f && y <= extent) ? 1.0f : 0.0f;
    const float yc = fmaxf(y, 0.0f);
    float y_low = floorf(yc);
    const bool cap = y_low >= extent - 1.0f;
    y_low = cap ? extent - 1.0f : y_low;
    const float y_high = cap ? extent - 1.0f : __fadd_rn(y_low, 1.0f);
    const float ly = cap ? 0.0f : __fsub_rn(yc, y_low);
    const float hy = __fsub_rn(1.0f, ly);
#pragma unroll
    for (int g = 0; g < kExtent; ++g) {
      const float gf = static_cast<float>(g);
      const float w = __fadd_rn(__fmul_rn(hy, gf == y_low ? 1.0f : 0.0f),
                                __fmul_rn(ly, gf == y_high ? 1.0f : 0.0f));
      acc[g] = __fadd_rn(acc[g], __fmul_rn(w, valid));
    }
  }
#pragma unroll
  for (int g = 0; g < kExtent; ++g)
    row[g] = __fdiv_rn(acc[g], static_cast<float>(kSampling));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 float* __restrict__ out, int n, int c, float scale) {
  __shared__ float ay[kRois][kP][kExtent];
  __shared__ float ax[kRois][kP][kExtent];

  const int b = blockIdx.z;
  const int roi0 = blockIdx.y * kRois;
  const int nrois = min(kRois, n - roi0);

  // 2 axes x kRois x kP weight rows, one per thread
  for (int row = threadIdx.x; row < 2 * kRois * kP; row += blockDim.x) {
    const int axis = row / (kRois * kP);  // 0: y (rows), 1: x (columns)
    const int r = (row / kP) % kRois;
    const int p = row % kP;
    float* dst = axis == 0 ? ay[r][p] : ax[r][p];
    if (r >= nrois) continue;
    const float* bx = boxes + (static_cast<size_t>(b) * n + roi0 + r) * 4;
    const float start = __fmul_rn(bx[axis == 0 ? 1 : 0], scale);
    const float end = __fmul_rn(bx[axis == 0 ? 3 : 2], scale);
    const float len = fmaxf(__fsub_rn(end, start), 1.0f);
    axis_weights_row(start, __fdiv_rn(len, static_cast<float>(kP)), p, dst);
  }
  __syncthreads();

  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const T* f = feats + static_cast<size_t>(b) * kExtent * kExtent * c + ch;

  for (int r = 0; r < nrois; ++r) {
    float acc[kP][kP];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kP; ++q) acc[p][q] = 0.0f;

#pragma unroll 1
    for (int h = 0; h < kExtent; ++h) {
      float row[kExtent];
#pragma unroll
      for (int w = 0; w < kExtent; ++w)
        row[w] = to_f32(f[static_cast<size_t>(h * kExtent + w) * c]);
      float u[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kExtent; ++w) s += ax[r][q][w] * row[w];
        u[q] = s;
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float a = ay[r][p][h];
#pragma unroll
        for (int q = 0; q < kP; ++q) acc[p][q] += a * u[q];
      }
    }

    float* o = out + (static_cast<size_t>(b) * n + roi0 + r) * kP * kP * c + ch;
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kP; ++q)
        o[static_cast<size_t>(p * kP + q) * c] = acc[p][q];
  }
}

}  // namespace

// feats [batch, height, width, c] (f32, or bf16 when feats_bf16 != 0),
// boxes [batch, n, 4] f32, out [batch, n, pooled, pooled, c] f32, all
// contiguous. Only the model's geometry is compiled: a 16x16 map, 8x8 bins,
// sampling 2. Returns the CUDA error code of the launch (0 on success).
extern "C" int rgrg_roi_align(const void* feats, int feats_bf16,
                              const void* boxes, void* out, int batch,
                              int height, int width, int c, int n, int pooled,
                              int sampling, float scale, void* stream) {
  if (height != kExtent || width != kExtent || pooled != kP ||
      sampling != kSampling || batch <= 0 || n <= 0 || c <= 0 ||
      batch > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((c + kThreads - 1) / kThreads, (n + kRois - 1) / kRois, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    roi_align_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats), static_cast<const float*>(boxes),
        static_cast<float*>(out), n, c, scale);
  } else {
    roi_align_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(boxes),
        static_cast<float*>(out), n, c, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
