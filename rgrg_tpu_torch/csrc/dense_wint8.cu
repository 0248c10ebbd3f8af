// Dense product with weight-only int8 weights, dequantised on chip.
//
// Replaces: rgrg_tpu/ops/dense_wint8_pallas.py `_kernel_bias` /
// `_kernel_nobias` (entry `dense_wint8`), which keeps the whole x block in
// VMEM, streams one int8 column block of q per grid step, casts it to x's
// dtype in VMEM and applies the scale and bias on the f32 accumulator.
// The function, not the TPU's blocking, is carried over:
//
//   y[m, n] = cast_to_x_dtype(sum_k x[m, k] * q[k, n] * scale[n] + bias[n])
//
// with x [M, K] bf16 or f32, q [K, N] int8, scale [N] f32 and an optional
// bias [N] in f32 or bf16, the sum in f32. The JAX package falls back to
// an XLA product for shapes that do not tile; this kernel masks ragged M, K
// and N itself, so every shape takes the one route.
//
// What bounds it on the H100: the int8 weight bytes. GPT-2 Medium's four
// per-layer products read 12.6 MB of int8 weights a layer, 302 MB per
// decode step over 24 layers: 0.090 ms at 3.35 TB/s (0.180 ms for the bf16
// weights that weights_int8=False reads). The work, 2 * M * 302 M FLOP, is
// below the bf16 tensor-core ridge at every decode shape (M = 64 greedy
// rows, 256 beam lanes): one c_fc launch at M = 64 moves ~4.85 MB (1.45 us)
// for 0.54 GFLOP (0.55 us at 989 TFLOP/s).
//
// Design: a block computes a 64 x 64 tile of y with 128 threads and walks
// its share of K in steps of BK (64 for bf16, 32 for f32). Each step stages
// the x tile (in x's dtype) and the int8 q tile in shared memory; the loads
// of the next step go to registers while the current step computes, 16
// bytes a thread where the shapes allow it and element by element (zero
// filled past the edges) where they do not. bf16 x: mma.sync m16n8k16 with
// f32 accumulators, four warps of 32 x 32; the int8 weights are converted
// to bf16 as the B fragments are built (exact: |q| <= 127). f32 x: FMA on
// CUDA cores (no TF32), 4 x 8 outputs a thread.
//
// Occupancy at decode shapes: at M = 64 there are only 16 (N = 1024) to 64
// (N = 4096) tiles for 132 SMs, and each would stream K x 64 bytes of
// weights alone. So K is split over `splits` blocks per tile (a power of
// two, chosen by the wrapper so that tiles x splits >= 2 x the SM count,
// at most 8 and at most K / BK): at M = 64 the c_attn, c_fc and both c_proj
// launches run 384, 512, 128 and 128 blocks. Each split writes its f32
// partial tile to a workspace; the block that finishes last (an atomic
// count per tile) sums the partials in split order, so the result does not
// depend on which block ends last, applies scale and bias, casts, and
// zeroes the count for the next launch. The counts live in a buffer the
// wrapper keeps zeroed between launches; launches on one stream run in
// order, so they never share a count. Later PRs: TMA/wgmma tiles and a
// persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kMaxSplits = 8;

template <typename T>
struct Tile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int kApad = 16 / sizeof(T);  // keeps rows 16-byte aligned
  static constexpr int kBpad = 16;
  static constexpr int kVecA = 16 / sizeof(T);  // x elements per 16-byte chunk
  static constexpr int kChunksA = kBM * BK / kVecA / kThreads;
  static constexpr int kChunksB = BK * kBN / 16 / kThreads;
  static_assert(kChunksA * kVecA * kThreads == kBM * BK, "x tile split");
  static_assert(kChunksB * 16 * kThreads == BK * kBN, "q tile split");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// two int8 weights (k, k+1 of one column) as a bf16 pair, low half first
__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const void* bias;
  int bias_kind;  // 0 none, 1 f32, 2 bf16
  void* out;
  float* ws;      // [splits, M, N] f32 partials (splits > 1)
  int* counts;    // one per (m, n) tile, zero between launches
  int m, n, k, splits, k_per_split;
  bool vec_x, vec_q;
};

__device__ __forceinline__ float bias_at(const Args& a, int n) {
  if (a.bias_kind == 1) return static_cast<const float*>(a.bias)[n];
  if (a.bias_kind == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n]);
  return 0.0f;
}

// y = acc * scale + bias, rounded per operation as the plain version does
__device__ __forceinline__ float epilogue(const Args& a, float acc, int n) {
  return __fadd_rn(__fmul_rn(acc, a.scale[n]), bias_at(a, n));
}

template <typename T>
__device__ __forceinline__ void load_x(const Args& a, uint4* r, int m0, int k0, int k_end) {
  using TL = Tile<T>;
  const T* x = static_cast<const T*>(a.x);
#pragma unroll
  for (int i = 0; i < TL::kChunksA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / (TL::BK / TL::kVecA);
    const int col = (c % (TL::BK / TL::kVecA)) * TL::kVecA;
    const int m = m0 + row, k = k0 + col;
    if (a.vec_x) {
      // K is a multiple of the chunk, so a chunk is wholly in or out
      r[i] = (m < a.m && k < k_end)
                 ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * a.k + k)
                 : make_uint4(0, 0, 0, 0);
    } else {
      alignas(16) T v[TL::kVecA];
#pragma unroll
      for (int e = 0; e < TL::kVecA; ++e)
        v[e] = (m < a.m && k + e < k_end) ? x[static_cast<size_t>(m) * a.k + k + e] : T(0.0f);
      r[i] = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_q(const Args& a, uint4* r, int n0, int k0, int k_end) {
  using TL = Tile<T>;
#pragma unroll
  for (int i = 0; i < TL::kChunksB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / (kBN / 16);
    const int col = (c % (kBN / 16)) * 16;
    const int k = k0 + row, n = n0 + col;
    if (a.vec_q) {
      // N is a multiple of 16, so a chunk is wholly in or out
      r[i] = (k < k_end && n < a.n)
                 ? *reinterpret_cast<const uint4*>(a.q + static_cast<size_t>(k) * a.n + n)
                 : make_uint4(0, 0, 0, 0);
    } else {
      alignas(16) int8_t v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = (k < k_end && n + e < a.n) ? a.q[static_cast<size_t>(k) * a.n + n + e] : 0;
      r[i] = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Writes one output value of this block's tile: straight to y when K is
// not split, else to this split's partial tile.
template <typename T>
__device__ __forceinline__ void emit(const Args& a, int m, int n, float acc) {
  if (m >= a.m || n >= a.n) return;
  if (a.splits == 1) {
    store_out(static_cast<T*>(a.out) + static_cast<size_t>(m) * a.n + n, epilogue(a, acc, n));
  } else {
    a.ws[(static_cast<size_t>(blockIdx.z) * a.m + m) * a.n + n] = acc;
  }
}

// Split-K fixup: the last split of a tile to finish sums the partials in
// split order, applies the epilogue and resets the tile's count.
template <typename T>
__device__ void fixup(const Args& a, int m0, int n0) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(&a.counts[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m >= a.m || n >= a.n) continue;
    float acc = 0.0f;
    for (int z = 0; z < a.splits; ++z)
      acc += __ldcg(a.ws + (static_cast<size_t>(z) * a.m + m) * a.n + n);
    store_out(static_cast<T*>(a.out) + static_cast<size_t>(m) * a.n + n, epilogue(a, acc, n));
  }
  if (threadIdx.x == 0) a.counts[tile] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dense_wint8_kernel(Args a) {
  using TL = Tile<T>;
  constexpr int BK = TL::BK;
  __shared__ __align__(16) T xs[kBM][BK + TL::kApad];
  __shared__ __align__(16) int8_t qs[BK][kBN + TL::kBpad];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(a.k, k_begin + a.k_per_split);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane >> 2, tig = lane & 3;
  const int warp_m = (warp / 2) * 32, warp_n = (warp % 2) * 32;
  const int ty = tid / 8, tx = tid % 8;  // f32 path: rows ty + 16 i, cols tx + 8 j

  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  uint4 rx[TL::kChunksA], rq[TL::kChunksB];
  if (k_begin < k_end) {
    load_x<T>(a, rx, m0, k_begin, k_end);
    load_q<T>(a, rq, n0, k_begin, k_end);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step's reads of the tiles are done
#pragma unroll
    for (int i = 0; i < TL::kChunksA; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&xs[c / (BK / TL::kVecA)][(c % (BK / TL::kVecA)) * TL::kVecA]) =
          rx[i];
    }
#pragma unroll
    for (int i = 0; i < TL::kChunksB; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&qs[c / (kBN / 16)][(c % (kBN / 16)) * 16]) = rq[i];
    }
    __syncthreads();
    if (k0 + BK < k_end) {  // the next step's loads fly while this one computes
      load_x<T>(a, rx, m0, k0 + BK, k_end);
      load_q<T>(a, rq, n0, k0 + BK, k_end);
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = warp_m + mi * 16 + group, c = kk + tig * 2;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][c]);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c]);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][c + 8]);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][c + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = warp_n + ni * 8 + group, k = kk + tig * 2;
          bf[ni][0] = pack_bf16(qs[k][n], qs[k + 1][n]);
          bf[ni][1] = pack_bf16(qs[k + 8][n], qs[k + 9][n]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(&acc[(mi * 4 + ni) * 4], af[mi], bf[ni]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float xv[4], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = to_f32(xs[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[j] = static_cast<float>(qs[kk][tx + 8 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(xv[i], qv[j], acc[i * 8 + j]);
      }
    }
  }

  if constexpr (kBf16) {
    // mma accumulator layout: c0/c1 at (group, 2 tig + {0,1}), c2/c3 eight rows below
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* c = &acc[(mi * 4 + ni) * 4];
        const int m = m0 + warp_m + mi * 16 + group;
        const int n = n0 + warp_n + ni * 8 + tig * 2;
        emit<T>(a, m, n, c[0]);
        emit<T>(a, m, n + 1, c[1]);
        emit<T>(a, m + 8, n, c[2]);
        emit<T>(a, m + 8, n + 1, c[3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) emit<T>(a, m0 + ty + 16 * i, n0 + tx + 8 * j, acc[i * 8 + j]);
  }
  if (a.splits > 1) fixup<T>(a, m0, n0);
}

}  // namespace

// y [m, n] (x's dtype) = (x [m, k] @ q [k, n]) * scale [n] (+ bias [n]).
// x_kind 0: f32, 1: bf16; bias_kind 0: none, 1: f32, 2: bf16. ws holds
// splits * m * n floats when splits > 1 (else may be null); counts holds
// one zeroed int per (m, n) tile of 64 x 64. k_per_split is a multiple of
// the kernel's BK (64 for bf16 x, 32 for f32 x). All arrays contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rgrg_dense_wint8(const void* x, int x_kind, const void* q, const void* scale,
                                const void* bias, int bias_kind, void* out, void* ws,
                                void* counts, int m, int n, int k, int splits,
                                int k_per_split, void* stream) {
  const int bk = x_kind == 0 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
  if (m <= 0 || n <= 0 || k < 0 || x_kind < 0 || x_kind > 1 || bias_kind < 0 ||
      bias_kind > 2 || (bias_kind != 0 && bias == nullptr) || splits < 1 ||
      splits > kMaxSplits || counts == nullptr || (splits > 1 && ws == nullptr) ||
      k_per_split <= 0 || k_per_split % bk != 0 ||
      static_cast<long long>(splits) * k_per_split < k ||
      (splits > 1 && static_cast<long long>(splits - 1) * k_per_split >= k)) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.bias = bias;
  a.bias_kind = bias_kind;
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counts = static_cast<int*>(counts);
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = splits;
  a.k_per_split = k_per_split;
  const int vec_x = x_kind == 0 ? 4 : 8;
  a.vec_x = k % vec_x == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_q = n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0) {
    dense_wint8_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else {
    dense_wint8_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
