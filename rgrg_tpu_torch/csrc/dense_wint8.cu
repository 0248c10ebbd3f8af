// Dense product with weight-only int8 weights, dequantised on chip (K4).
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
// bias [N] in f32 or bf16, the sum in f32. Every shape takes this kernel:
// ragged M, K and N are masked in the kernel.
//
// What bounds it on the H100: bytes. GPT-2 Medium's four per-layer products
// read 12.6 MB of int8 weights a layer (302 MB per decode step over 24
// layers, 0.090 ms at 3.35 TB/s). The work, 2 * M * K * N FLOP, is below the
// bf16 tensor-core ridge at every decode shape: at M = 64 (greedy rows) c_fc
// moves ~4.9 MB (1.45 us) for 0.54 GFLOP (0.55 us at 989 TFLOP/s). So the
// design streams the int8 weights once and moves nothing else of comparable
// size; at decode shapes a launch is short, so what it pays besides the
// bytes (launch, the first load's latency, the split-K reduction) is kept to
// one pass and one cluster barrier, and the launch is a programmatic
// dependent launch, so its start overlaps the previous kernel's tail:
//
// - Tiles and split-K. A block (256 threads, two warpgroups) owns a 64 x 128
//   tile of y and a contiguous share of K. At decode shapes a layer has only
//   8-32 such tiles, so K is split over `splits` blocks (1-8, the wrapper's
//   planner, ops/dense_wint8.py `plan`) that form one thread block cluster
//   along K. There is no global workspace and no atomic: rank r owns rows
//   [r * rows, (r + 1) * rows) of the tile (rows = ceil(64 / splits)); each
//   block writes those rows of its f32 partial tile into slot `rank` of r's
//   inbox in r's shared memory (distributed shared memory), and after one
//   cluster barrier r sums its slots in rank order, applies scale and bias,
//   casts and stores. The order is fixed, so a launch is bit-identical to
//   the next. An early relaxed arrive on the cluster barrier tells the
//   writers that every block of the cluster runs.
// - The weight stream. A ring of 4 shared-memory stages holds the x and q
//   tiles of 4 K-steps; `cp.async` (16 bytes a thread, L2 only) fills each
//   stage 2 steps ahead of its use, the other stages stay with the tensor
//   work in flight. `cp.async` rather than TMA: x is a fresh activation on
//   every call, so a tensor map for it would be rebuilt on the host per
//   call, and at decode shapes a block's whole share of K is 2-8 steps. Shapes
//   the 16-byte copies cannot take (N % 16 != 0, K * sizeof(x) % 16 != 0, a
//   base not aligned to 16 bytes) load the same tiles element by element,
//   zero-filled past the edges.
// - Tensor cores fed from words. bf16 x runs `wgmma` m64n64k16 on y^T =
//   q^T x^T: A is 64 output columns of q, converted to bf16 in registers
//   (exact: |q| <= 127; the biased byte q + 128 is placed under the
//   exponent of 2^23 with one byte permute, 2^23 + 128 is subtracted, and
//   the bf16 is the float's upper half), B is the x tile, stored by the
//   copies in wgmma's 128-byte swizzle. A warp's 16 A rows are interleaved
//   so that one 16-bit word of q per K row feeds a thread, and each weight
//   is converted once per block. K-step i's wgmmas are issued before step
//   i + 1 is converted (A in two register buffers); ptxas still serializes
//   them (its note C7513), and an A operand staged in shared memory instead
//   avoids that but measured no faster at decode shapes.
// - f32 x runs FMA on CUDA cores (no TF32) and is bound by operations, not
//   bytes: a thread owns 8 rows x 4 columns, a lane converts one word of q
//   per K row (so 8 threads convert each weight), and a warp reads its x
//   rows 4 K at a time as broadcasts. The planner gives f32 launches as
//   many splits as fit one wave of two blocks per SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;
constexpr int kPartStride = kBN + 4;  // floats per row of the f32 partial tile
// the inbox receives every rank's partial rows for this block's share:
// splits * ceil(64 / splits) <= 70 rows of kBN floats
constexpr int kInboxRows = 72;

template <typename T>
struct Tile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int kVecX = 16 / sizeof(T);          // x elements per 16-byte chunk
  // bf16 x rows are 128 bytes, stored in wgmma's 128-byte swizzle (16-byte
  // chunk c of row r at chunk c ^ (r % 8)); f32 rows carry 16 bytes of
  // padding instead
  static constexpr bool kSwizzle = !std::is_same<T, float>::value;
  static constexpr int kXStride = kSwizzle ? BK : BK + kVecX;  // elements
  static constexpr int kQStride = kBN + 16;             // bytes (16 bytes of padding)
  static constexpr int kXBytes = kBM * kXStride * static_cast<int>(sizeof(T));
  static constexpr int kQBytes = BK * kQStride;
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartBytes = kBM * kPartStride * 4;
  static constexpr int kInboxOffset = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  // + 1 KB to align the ring to the 1024 bytes the swizzle needs
  static constexpr int kSmemBytes = kInboxOffset + kInboxRows * kBN * 4 + 1024;
  static constexpr int kChunksX = kBM * BK / kVecX / kThreads;
  static constexpr int kChunksQ = BK * kBN / 16 / kThreads;
  static_assert(kChunksX * kVecX * kThreads == kBM * BK, "x tile split");
  static_assert(kChunksQ * 16 * kThreads == BK * kBN, "q tile split");
  static_assert(kXBytes % 16 == 0 && kStageBytes % 16 == 0, "16-byte aligned stages");
  static_assert(!kSwizzle || (BK * sizeof(T) == 128 && kXBytes % 1024 == 0 &&
                              kStageBytes % 1024 == 0), "1024-byte aligned swizzled tiles");
};

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  const void* bias;
  int bias_kind;  // 0 none, 1 f32, 2 bf16
  void* out;
  int m, n, k, splits, k_per_split;
  bool vec_x, vec_q;  // 16-byte copies possible
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bias_at(const Args& a, int n) {
  if (a.bias_kind == 1) return static_cast<const float*>(a.bias)[n];
  if (a.bias_kind == 2) return __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n]);
  return 0.0f;
}

// 16 bytes global -> shared, asynchronous, L2 only; `full` false writes
// zeros and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t lds16(const void* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a stage's x tile.
template <typename T>
__device__ __forceinline__ int x_offset(int row, int chunk) {
  using TL = Tile<T>;
  if constexpr (TL::kSwizzle) {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
  } else {
    return row * TL::kXStride * static_cast<int>(sizeof(T)) + (chunk << 4);
  }
}

// wgmma operand B: a K-major bf16 tile of 128-byte rows in the 128-byte
// swizzle, 8-row groups 1024 bytes apart, starting at p (one k16 slice)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d [64 x 64] f32 (this warpgroup's accumulators) += A [64 x 16] bf16 from
// registers (mma's A fragment layout per warp) x B [16 x 64] bf16 in
// shared memory (descriptor)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the cluster barrier in two halves (all threads of every block)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Byte j of a word of biased weights (q + 128) as the float q, exactly:
// 0x4B0000bb is 2^23 + bb. sel = 0x7540 | j.
__device__ __forceinline__ float weight_f32(uint32_t biased, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, sel)), 8388736.0f);
}


// Starts the loads of one K-step's x tile [64, BK] and q tile [BK, 128]
// into a stage: 16-byte asynchronous copies where the shapes allow them,
// else element loads stored to shared memory (zero past the edges).
template <typename T>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* stage, int m0, int n0,
                                           int k0, int k_end) {
  using TL = Tile<T>;
  int8_t* qs = reinterpret_cast<int8_t*>(stage + TL::kXBytes);
  const T* x = static_cast<const T*>(a.x);
#pragma unroll
  for (int i = 0; i < TL::kChunksX; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / (TL::BK / TL::kVecX);
    const int col = (c % (TL::BK / TL::kVecX)) * TL::kVecX;
    const int m = m0 + row, k = k0 + col;
    T* dst = reinterpret_cast<T*>(stage + x_offset<T>(row, col / TL::kVecX));
    if (a.vec_x) {
      // K is a multiple of the chunk, so a chunk is wholly in or out
      const bool in = m < a.m && k < k_end;
      cp_async16(dst, in ? x + static_cast<size_t>(m) * a.k + k : x, in);
    } else {
      alignas(16) T v[TL::kVecX];
#pragma unroll
      for (int e = 0; e < TL::kVecX; ++e)
        v[e] = (m < a.m && k + e < k_end) ? x[static_cast<size_t>(m) * a.k + k + e] : T(0.0f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
#pragma unroll
  for (int i = 0; i < TL::kChunksQ; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / (kBN / 16);
    const int col = (c % (kBN / 16)) * 16;
    const int k = k0 + row, n = n0 + col;
    int8_t* dst = qs + row * TL::kQStride + col;
    if (a.vec_q) {
      // N is a multiple of 16, so a chunk is wholly in or out
      const bool in = k < k_end && n < a.n;
      cp_async16(dst, in ? a.q + static_cast<size_t>(k) * a.n + n : a.q, in);
    } else {
      alignas(16) int8_t v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = (k < k_end && n + e < a.n) ? a.q[static_cast<size_t>(k) * a.n + n + e] : 0;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// One K-step on tensor cores, y^T = q^T x^T: warpgroup wg (warps 4 wg ..
// 4 wg + 3) computes output columns 64 wg + [0, 64) for all 64 rows with
// wgmma m64n64k16, A = the int8 weights converted to bf16 in registers,
// B = the x tile in shared memory. Warp w's A rows (output columns) are
// 16 w + [0, 16), interleaved so one 16-bit word of q per K row feeds a
// thread: logical row r is physical column 16 warp + 2 (r % 8) + r / 8.
// Each weight is converted once per block. acc[j * 4 + c] holds D(row g +
// 8 (c / 2), x row 8 j + 2 t + c % 2).
__device__ __forceinline__ void convert_bf16(const unsigned char* stage,
                                             uint32_t (&af)[Tile<__nv_bfloat16>::BK / 16][4]) {
  using TL = Tile<__nv_bfloat16>;
  const int8_t* qs = reinterpret_cast<const int8_t*>(stage + TL::kXBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* q_lane = qs + 2 * t * TL::kQStride + warp * 16 + 2 * g;
#pragma unroll
  for (int s = 0; s < TL::BK / 16; ++s) {
    // rows k, k+1 and k+8, k+9 (k = 16 s + 2t) of physical columns 2g, 2g+1
    // (logical rows g, g+8), biased: bytes (k, g), (k, g+8), (k+1, g), (k+1, g+8)
    const int8_t* qp = q_lane + 16 * s * TL::kQStride;
    const uint32_t lo =
        __byte_perm(lds16(qp), lds16(qp + TL::kQStride), 0x5410) ^ 0x80808080u;
    const uint32_t hi =
        __byte_perm(lds16(qp + 8 * TL::kQStride), lds16(qp + 9 * TL::kQStride), 0x5410) ^
        0x80808080u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      af[s][h] = __byte_perm(__float_as_uint(weight_f32(lo, 0x7540u | h)),
                             __float_as_uint(weight_f32(lo, 0x7540u | (2 + h))), 0x7632);
      af[s][2 + h] = __byte_perm(__float_as_uint(weight_f32(hi, 0x7540u | h)),
                                 __float_as_uint(weight_f32(hi, 0x7540u | (2 + h))), 0x7632);
    }
  }
}

// Issues the K-step's wgmmas as one group (not waited for here).
__device__ __forceinline__ void issue_bf16(const unsigned char* stage,
                                           const uint32_t (&af)[Tile<__nv_bfloat16>::BK / 16][4],
                                           float* acc) {
  using TL = Tile<__nv_bfloat16>;
  wgmma_fence();  // the A registers are written
#pragma unroll
  for (int s = 0; s < TL::BK / 16; ++s) wgmma_m64n64k16(acc, af[s], desc_sw128(stage + 32 * s));
  wgmma_commit();
}

// One K-step on CUDA cores: thread (warp, lane) owns rows warp + 8 i (i <
// 8) and columns 4 lane + j (j < 4), acc[i * 4 + j]. A warp reads its x
// rows 4 K at a time as broadcasts and one word of q per lane (a 128-byte
// row, no bank conflict), so each weight is converted by 8 threads, not 16.
__device__ __forceinline__ void step_f32(const unsigned char* stage, float* acc) {
  using TL = Tile<float>;
  const float* xs = reinterpret_cast<const float*>(stage);
  const int8_t* qs = reinterpret_cast<const int8_t*>(stage + TL::kXBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 2
  for (int k4 = 0; k4 < TL::BK; k4 += 4) {
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xs + (warp + 8 * i) * TL::kXStride + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t w = lds32(qs + (k4 + kk) * TL::kQStride + 4 * lane) ^ 0x80808080u;
      float qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = weight_f32(w, 0x7540u | j);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i * 4 + j] = fmaf(xk, qv[j], acc[i * 4 + j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) dense_wint8_kernel(Args a) {
  using TL = Tile<T>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // K-steps the loads run ahead: with bf16 x two stages stay with the
  // wgmmas of the step in flight and of the step before it
  constexpr int kLead = kBf16 ? kStages - 2 : kStages - 1;
  // launched as a programmatic dependent launch: the blocks may start while
  // the previous kernel of the stream finishes; every memory access waits
  // here until it has, so the stream's order holds
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring starts 1024-byte aligned (the same offset in every block)
  unsigned char* smem =
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) &
                  1023);
  // every block of the cluster marks that it runs, before any block writes
  // to another's shared memory (waited for after the main loop)
  cluster_arrive_relaxed();

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(a.k, k_begin + a.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + TL::BK - 1) / TL::BK : 0;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  // the ring: stage s % kStages holds K-step s; loads run kLead ahead
#pragma unroll
  for (int s = 0; s < kLead; ++s) {
    if (s < steps)
      load_stage<T>(a, smem + s * TL::kStageBytes, m0, n0, k_begin + s * TL::BK, k_end);
    cp_async_commit();
  }
  // this thread's four output columns in the reduction below: their scale
  // and bias, read while the weights stream
  const int c = (threadIdx.x % (kBN / 4)) * 4;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = min(n0 + c + j, a.n - 1);
    sc[j] = a.scale[n];
    bi[j] = bias_at(a, n);
  }
  if constexpr (kBf16) {
    // K-step i's wgmmas run while step i + 1 is converted: A registers in
    // two buffers, at most one wgmma group in flight, loads kLead steps ahead
    // into the stage that step i - 2 used (its group is complete)
    uint32_t af[2][TL::BK / 16][4];
    auto step = [&](int i, uint32_t(&buf)[TL::BK / 16][4]) {
      cp_async_wait<kLead - 1>();  // this thread's copies of step i have landed
      fence_proxy_async();
      __syncthreads();  // everyone's have; step i - 2's wgmmas are done
      if (i + kLead < steps)
        load_stage<T>(a, smem + ((i + kLead) % kStages) * TL::kStageBytes, m0, n0,
                      k_begin + (i + kLead) * TL::BK, k_end);
      cp_async_commit();
      const unsigned char* stage = smem + (i % kStages) * TL::kStageBytes;
      convert_bf16(stage, buf);
      issue_bf16(stage, buf, acc);
      wgmma_wait<1>();  // step i - 1's group is done
    };
    for (int i = 0; i < steps; i += 2) {
      step(i, af[0]);
      if (i + 1 < steps) step(i + 1, af[1]);
    }
    wgmma_wait<0>();
  } else {
    for (int i = 0; i < steps; ++i) {
      cp_async_wait<kLead - 1>();
      __syncthreads();
      if (i + kLead < steps)
        load_stage<T>(a, smem + ((i + kLead) % kStages) * TL::kStageBytes, m0, n0,
                      k_begin + (i + kLead) * TL::BK, k_end);
      cp_async_commit();
      step_f32(smem + (i % kStages) * TL::kStageBytes, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: reuse it for the partial tile

  float* part = reinterpret_cast<float*>(smem);
  if constexpr (kBf16) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    // D(row g (+8), x row 8j + 2t (+1)): output column 16 warp + 2g (+1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* p = part + (8 * j + 2 * t) * kPartStride + warp * 16 + 2 * g;
      p[0] = acc[4 * j];
      p[kPartStride] = acc[4 * j + 1];
      p[1] = acc[4 * j + 2];
      p[kPartStride + 1] = acc[4 * j + 3];
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(part + (warp + 8 * i) * kPartStride + 4 * lane) =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();

  // split-K across the cluster, pushed: rank r owns rows [r * rows, (r + 1)
  // * rows) of the tile; every block writes those rows of its partial tile
  // into slot `rank` of r's inbox, one cluster barrier later r sums its
  // slots in rank order (a fixed order: launches are bit-identical),
  // applies scale and bias, casts and stores. Nothing reads another
  // block's shared memory, so no block waits for the others to finish.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = (kBM + a.splits - 1) / a.splits;
  float* inbox = reinterpret_cast<float*>(smem + TL::kInboxOffset);
  cluster_wait();  // every block of the cluster runs: its inbox exists
  for (int e = threadIdx.x; e < kBM * (kBN / 4); e += kThreads) {
    const int r = e / (kBN / 4), cc = (e % (kBN / 4)) * 4;
    float* dst = cluster.map_shared_rank(inbox + ((rank * rows + r % rows) * kBN + cc),
                                         r / rows);
    *reinterpret_cast<float4*>(dst) =
        *reinterpret_cast<const float4*>(part + r * kPartStride + cc);
  }
  cluster.sync();  // release / acquire: every block's pushes have landed
  const int r_end = min(rows, kBM - rank * rows);
  for (int r = threadIdx.x / (kBN / 4); r < r_end; r += kThreads / (kBN / 4)) {
    float4 s = *reinterpret_cast<const float4*>(inbox + r * kBN + c);
    for (int z = 1; z < a.splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(inbox + (z * rows + r) * kBN + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int m = m0 + rank * rows + r;
    if (m >= a.m) break;
    const float sv[4] = {s.x, s.y, s.z, s.w};
    T* out = static_cast<T*>(a.out) + static_cast<size_t>(m) * a.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + c + j < a.n) store_out(out + n0 + c + j, __fadd_rn(__fmul_rn(sv[j], sc[j]), bi[j]));
    }
  }
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  using TL = Tile<T>;
  // the shared-memory limit is set once per device (above 48 KB it must be)
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(dense_wint8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM, a.splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = TL::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  // the launch overlaps the previous kernel's tail (griddepcontrol.wait)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, dense_wint8_kernel<T>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [m, n] (x's dtype) = (x [m, k] @ q [k, n]) * scale [n] (+ bias [n]).
// x_kind 0: f32, 1: bf16; bias_kind 0: none, 1: f32, 2: bf16. K is split
// over `splits` (1..8) blocks of one cluster, k_per_split each (a multiple
// of the kernel's BK: 64 for bf16 x, 32 for f32 x; no split empty). All
// arrays contiguous. Allocates nothing. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int rgrg_dense_wint8(const void* x, int x_kind, const void* q, const void* scale,
                                const void* bias, int bias_kind, void* out, int m, int n, int k,
                                int splits, int k_per_split, void* stream) {
  const int bk = x_kind == 0 ? Tile<float>::BK : Tile<__nv_bfloat16>::BK;
  if (m <= 0 || n <= 0 || k < 0 || x_kind < 0 || x_kind > 1 || bias_kind < 0 ||
      bias_kind > 2 || (bias_kind != 0 && bias == nullptr) || splits < 1 ||
      splits > kMaxSplits || k_per_split <= 0 || k_per_split % bk != 0 ||
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
  a.m = m;
  a.n = n;
  a.k = k;
  a.splits = splits;
  a.k_per_split = k_per_split;
  const int vec_x = x_kind == 0 ? 4 : 8;  // elements per 16 bytes
  a.vec_x = k % vec_x == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_q = n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_kind == 0 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
