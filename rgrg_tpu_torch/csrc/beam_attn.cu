// Ancestry-masked attention of one beam-decode step, for one layer.
//
// Replaces: rgrg_tpu/ops/beam_attn_pallas.py `_beam_attn_kernel` (entry
// `beam_attention_pallas`), which streams an item block's whole K/V slice
// through VMEM and contracts it with zero-interleaved queries of head
// pairs, under a pre-flattened selection mask. Here each query row reads
// only the K/V rows its ancestry names, so neither the mask nor the
// interleaved queries exist:
//
//   ctx[r, h] = sum_{t0 <= t <= slot} softmax_t(scale * q[r, h] . K_t) * V_t,
//   K_t = k[h, (r / K) * K + anc[r, t], t]   (V_t likewise)
//
// Slots outside [t0, slot] are skipped. The JAX package masks them with a
// -1e4 (XLA) or -1e9 (Pallas) score bias, which underflows to exactly 0 in
// the f32 softmax, so skipping them computes the same function.
//
// What bounds it on the H100: bytes. At the main path's shape (384 lanes,
// 16 heads, 61 slots, 64 dims, bf16) the K and V rows the ancestry names
// are at most 384 x 61 x 16 x 64 x 2 B x 2 = 96 MB, 0.029 ms at 3.35 TB/s;
// rows shared by beams of one item need reading only once, so the bound
// is lower. The work is ~4 FLOP per (row, head, slot, dim), ~96 MFLOP:
// negligible. Each (row, head) is a chain of dependent slot steps, so the
// kernel is latency bound unless enough warps and loads are in flight.
//
// Design: one block per query row r, one warp per head (blockDim = 32 H).
// The block first resolves the row's source lane of every visible slot
// into shared memory (one read of the ancestry row for all heads). Each
// lane holds ceil(D / 32) of the head's dims (2 at D = 64, so a warp reads
// a 128-byte K or V row in one coalesced request). Per slot: the dot by
// warp shuffle, then an online softmax (running max and sum) that
// rescales the f32 context kept in registers. The loop is unrolled so the
// loads of several slots are in flight at once. An int8 cache is
// dequantised on load (value * scale), as the plain version does. Output
// is f32, as the Pallas kernel's. Later PRs can split the slots over
// several warps per head and merge the partial softmaxes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxHeads = 32;
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// VPL: head dims held by one lane (lane l holds dims l*VPL .. l*VPL+VPL-1)
template <typename TQ, typename TKV, int VPL>
__global__ void __launch_bounds__(kWarp * kMaxHeads)
beam_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ anc,
                 float* __restrict__ out, int bk, int heads, int t_total, int d,
                 int k_beams, int t0, int slot, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ int src_lane[];  // [slot + 1]: cache lane of each slot

  const int r = blockIdx.x;
  const int h = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int item_lane0 = (r / k_beams) * k_beams;
  const int* anc_row = anc + static_cast<size_t>(r) * t_total;
  for (int t = t0 + threadIdx.x; t <= slot; t += blockDim.x)
    src_lane[t] = item_lane0 + anc_row[t];
  __syncthreads();

  const TQ* q_row = q + (static_cast<size_t>(r) * heads + h) * d;
  float qv[VPL], acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = lane * VPL + j;
    qv[j] = e < d ? to_f32(q_row[e]) : 0.0f;
    acc[j] = 0.0f;
  }
  float m = -INFINITY;  // running max of the scores
  float l = 0.0f;       // running sum of exp(score - m)

#pragma unroll 4
  for (int t = t0; t <= slot; ++t) {
    // (h, source lane, t) row of the [H, B*K, T, D] cache
    const size_t row = (static_cast<size_t>(h) * bk + src_lane[t]) * t_total + t;
    const TKV* k_row = k + row * d;
    const TKV* v_row = v + row * d;
    float ks = 1.0f, vs = 1.0f;
    if constexpr (kQuant) {
      ks = k_scale[row];
      vs = v_scale[row];
    }
    float part = 0.0f;
    float vv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int e = lane * VPL + j;
      float kk = 0.0f;
      vv[j] = 0.0f;
      if (e < d) {
        kk = to_f32(k_row[e]);
        vv[j] = to_f32(v_row[e]);
        if constexpr (kQuant) {
          kk *= ks;
          vv[j] *= vs;
        }
      }
      part += qv[j] * kk;
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);

    const float s = part * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);  // 0 on the first slot (m = -inf)
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] = acc[j] * corr + p * vv[j];
    m = m_new;
  }

  const float inv = 1.0f / l;
  float* o = out + (static_cast<size_t>(r) * heads + h) * d;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = lane * VPL + j;
    if (e < d) o[e] = acc[j] * inv;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* anc, void* out, int bk, int heads,
                   int t_total, int d, int k_beams, int t0, int slot, float scale,
                   cudaStream_t stream) {
  const dim3 grid(bk);
  const dim3 block(kWarp * heads);
  const size_t smem = static_cast<size_t>(slot + 1) * sizeof(int);
  const auto* qp = static_cast<const TQ*>(q);
  const auto* kp = static_cast<const TKV*>(k);
  const auto* vp = static_cast<const TKV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* ap = static_cast<const int*>(anc);
  auto* op = static_cast<float*>(out);
  if (d <= kWarp) {
    beam_attn_kernel<TQ, TKV, 1><<<grid, block, smem, stream>>>(
        qp, kp, vp, ksp, vsp, ap, op, bk, heads, t_total, d, k_beams, t0, slot, scale);
  } else if (d <= 2 * kWarp) {
    beam_attn_kernel<TQ, TKV, 2><<<grid, block, smem, stream>>>(
        qp, kp, vp, ksp, vsp, ap, op, bk, heads, t_total, d, k_beams, t0, slot, scale);
  } else {
    beam_attn_kernel<TQ, TKV, 4><<<grid, block, smem, stream>>>(
        qp, kp, vp, ksp, vsp, ap, op, bk, heads, t_total, d, k_beams, t0, slot, scale);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_kind, const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale, const void* anc, void* out,
                      int bk, int heads, int t_total, int d, int k_beams, int t0, int slot,
                      float scale, cudaStream_t stream) {
  switch (kv_kind) {
    case 0:
      return launch<TQ, float>(q, k, v, k_scale, v_scale, anc, out, bk, heads, t_total, d,
                               k_beams, t0, slot, scale, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k, v, k_scale, v_scale, anc, out, bk, heads,
                                       t_total, d, k_beams, t0, slot, scale, stream);
    default:
      return launch<TQ, int8_t>(q, k, v, k_scale, v_scale, anc, out, bk, heads, t_total, d,
                                k_beams, t0, slot, scale, stream);
  }
}

}  // namespace

// q [bk, heads, d] (q_kind 0: f32, 1: bf16); k, v [heads, bk, t_total, d]
// (kv_kind 0: f32, 1: bf16, 2: int8 with k_scale/v_scale [heads, bk,
// t_total] f32); anc [bk, t_total] int32 ancestor beams (0..k_beams-1);
// out [bk, heads, d] f32; all contiguous. Attends over slots t0..slot.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rgrg_beam_attention(const void* q, int q_kind, const void* k,
                                   const void* v, int kv_kind, const void* k_scale,
                                   const void* v_scale, const void* anc, void* out,
                                   int bk, int heads, int t_total, int d, int k_beams,
                                   int t0, int slot, float scale, void* stream) {
  if (bk <= 0 || heads <= 0 || heads > kMaxHeads || d <= 0 || d > kMaxHeadDim ||
      k_beams <= 0 || bk % k_beams != 0 || t0 < 0 || t0 > slot || slot >= t_total ||
      q_kind < 0 || q_kind > 1 || kv_kind < 0 || kv_kind > 2 ||
      (kv_kind == 2 && (k_scale == nullptr || v_scale == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_kind == 0) {
    return static_cast<int>(launch_kv<float>(kv_kind, q, k, v, k_scale, v_scale, anc, out,
                                             bk, heads, t_total, d, k_beams, t0, slot,
                                             scale, s));
  }
  return static_cast<int>(launch_kv<__nv_bfloat16>(kv_kind, q, k, v, k_scale, v_scale, anc,
                                                   out, bk, heads, t_total, d, k_beams, t0,
                                                   slot, scale, s));
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
