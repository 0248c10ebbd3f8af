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
// touches at most 2 samples x 2 cells per axis, so a row of Ay or Ax has
// at most 4 nonzero cells and a bin at most 16 taps (at most 2048 FLOP per
// (ROI, channel), <= 0.13 ms at the 67 TFLOP/s f32 non-tensor peak). The
// feature map (2 or 4 MB per image) stays in the 50 MB L2.
//
// Design: one block per (channel tile, pair of ROIs, image).
// - Tap tables. The block first computes each of its ROIs' 8 + 8 weight
//   rows with the same float operations as `_axis_weights_block`
//   (round-to-nearest intrinsics, so no FMA reorders them) and keeps only
//   the nonzero cells, in ascending order, with their weights and their
//   element offsets in the map, in shared memory. Nothing assumes the
//   cells are adjacent: a ROI wider than the map or off its edge can name
//   cells further apart.
// - Contraction over the tables only: for each bin (p, q),
//   sum_{h in taps(p)} Ay[p,h] * sum_{w in taps(q)} Ax[q,w] * F[h,w,c],
//   W first, then H, each in ascending cell order, as explicit FMAs. A
//   skipped tap is an exact zero term of the dense contraction in the same
//   order, so for finite features the output equals the dense one bit for
//   bit, apart from the sign of zeros. The taps are read from L1/L2.
// - Channels: a thread owns 4 consecutive channels when C % 4 == 0 and the
//   pointers are aligned, so a feature read is 8 bytes (bf16) or 16 bytes
//   (f32) and each output is one 16-byte store with the streaming policy
//   (st.global.cs): the output cannot stay in the L2, and C5 should. Any
//   other C takes the scalar route, one channel a thread. Threads run along
//   C, so a warp's reads and stores are consecutive (coalesced).
// - Grid: 128 threads a block, 2 ROIs a block: 4,096 blocks at the serving
//   shape, several waves over the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kRois = 2;       // ROIs per block
constexpr int kP = 8;          // output bins per axis
constexpr int kExtent = 16;    // feature map height == width
constexpr int kSampling = 2;   // samples per bin edge
constexpr int kTaps = 2 * kSampling;  // nonzero cells of one weight row, at most

// The nonzero cells of one weight row (one bin along one axis).
struct Taps {
  float w[kTaps];  // weights, in ascending cell order
  int off[kTaps];  // element offsets of the cells in one image's map
  int n;           // how many
};

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

// V channels of a thread: loads widened to f32, FMAs and stores.
template <int V> struct Vec { float v[V]; };

__device__ __forceinline__ Vec<4> load(const float* p, Vec<4>) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return {{x.x, x.y, x.z, x.w}};
}
__device__ __forceinline__ Vec<4> load(const __nv_bfloat16* p, Vec<4>) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32
  return {{__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
           __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u)}};
}
__device__ __forceinline__ Vec<1> load(const float* p, Vec<1>) { return {{__ldg(p)}}; }
__device__ __forceinline__ Vec<1> load(const __nv_bfloat16* p, Vec<1>) {
  return {{__bfloat162float(*p)}};
}

__device__ __forceinline__ void store(float* p, const Vec<4>& x) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
}
__device__ __forceinline__ void store(float* p, const Vec<1>& x) { __stcs(p, x.v[0]); }

template <int V>
__device__ __forceinline__ void fma_into(Vec<V>& acc, float a, const Vec<V>& x) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc.v[i] = __fmaf_rn(a, x.v[i], acc.v[i]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 float* __restrict__ out, int n, int c, float scale) {
  __shared__ Taps taps[kRois][2][kP];  // [roi][axis 0: rows (y), 1: columns (x)][bin]

  const int b = blockIdx.z;
  const int roi0 = blockIdx.y * kRois;
  const int nrois = min(kRois, n - roi0);

  // 2 axes x kRois x kP weight rows, one per thread
  for (int row = threadIdx.x; row < 2 * kRois * kP; row += blockDim.x) {
    const int axis = row / (kRois * kP);
    const int r = (row / kP) % kRois;
    const int p = row % kP;
    if (r >= nrois) continue;
    const float* bx = boxes + (static_cast<size_t>(b) * n + roi0 + r) * 4;
    const float start = __fmul_rn(bx[axis == 0 ? 1 : 0], scale);
    const float end = __fmul_rn(bx[axis == 0 ? 3 : 2], scale);
    const float len = fmaxf(__fsub_rn(end, start), 1.0f);
    float dense[kExtent];
    axis_weights_row(start, __fdiv_rn(len, static_cast<float>(kP)), p, dense);
    const int stride = axis == 0 ? kExtent * c : c;
    Taps& t = taps[r][axis][p];
    int k = 0;
#pragma unroll
    for (int g = 0; g < kExtent; ++g) {
      // at most kTaps cells are nonzero: each sample weights two cells
      if (dense[g] != 0.0f && k < kTaps) {
        t.w[k] = dense[g];
        t.off[k] = g * stride;
        ++k;
      }
    }
    t.n = k;
  }
  __syncthreads();

  const int ch = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (ch >= c) return;
  const T* f = feats + static_cast<size_t>(b) * kExtent * kExtent * c + ch;

  for (int r = 0; r < nrois; ++r) {
    float* o = out + (static_cast<size_t>(b) * n + roi0 + r) * kP * kP * c + ch;
#pragma unroll 1
    for (int p = 0; p < kP; ++p) {
      const Taps& ty = taps[r][0][p];
      Vec<V> acc[kP] = {};
#pragma unroll 1
      for (int t = 0; t < ty.n; ++t) {
        const float a = ty.w[t];
        const T* fr = f + ty.off[t];
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          const Taps& tx = taps[r][1][q];
          Vec<V> u = {};
#pragma unroll
          for (int s = 0; s < kTaps; ++s)
            if (s < tx.n) fma_into(u, tx.w[s], load(fr + tx.off[s], Vec<V>{}));
#pragma unroll
          for (int i = 0; i < V; ++i) acc[q].v[i] = __fmaf_rn(a, u.v[i], acc[q].v[i]);
        }
      }
#pragma unroll
      for (int q = 0; q < kP; ++q) store(o + static_cast<size_t>(p * kP + q) * c, acc[q]);
    }
  }
}

template <typename T>
void launch(const void* feats, const void* boxes, void* out, int batch, int c,
            int n, float scale, cudaStream_t s) {
  const uintptr_t fa = reinterpret_cast<uintptr_t>(feats);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const bool vec = c % 4 == 0 && fa % (4 * sizeof(T)) == 0 && oa % 16 == 0;
  const int per_block = kThreads * (vec ? 4 : 1);
  const dim3 grid((c + per_block - 1) / per_block, (n + kRois - 1) / kRois, batch);
  const T* f = static_cast<const T*>(feats);
  const float* bx = static_cast<const float*>(boxes);
  float* o = static_cast<float*>(out);
  if (vec) {
    roi_align_kernel<T, 4><<<grid, kThreads, 0, s>>>(f, bx, o, n, c, scale);
  } else {
    roi_align_kernel<T, 1><<<grid, kThreads, 0, s>>>(f, bx, o, n, c, scale);
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
      batch > 65535 || (n + kRois - 1) / kRois > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    launch<__nv_bfloat16>(feats, boxes, out, batch, c, n, scale, s);
  } else {
    launch<float>(feats, boxes, out, batch, c, n, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
