// Ancestry-masked attention of one beam-decode step, for one layer (K3).
//
// Replaces: rgrg_tpu/ops/beam_attn_pallas.py `_beam_attn_kernel` (entry
// `beam_attention_pallas`), which streams an item block's whole K/V slice
// through VMEM and contracts it with zero-interleaved queries of head
// pairs, under a pre-flattened selection mask. The function, not the TPU's
// blocking, is carried over:
//
//   ctx[r, h] = sum_{t0 <= t <= slot} softmax_t(scale * q[r, h] . K_t) * V_t,
//   K_t = k[h, (r / K) * K + anc[r, t], t]   (V_t likewise)
//
// Slots outside [t0, slot] are skipped. The JAX package masks them with a
// -1e4 (XLA) or -1e9 (Pallas) score bias, which underflows to exactly 0 in
// the f32 softmax, so skipping them computes the same function.
//
// What bounds it on the H100: bytes. The beams of an item share most of
// their history, so the rows that must be read are the distinct (cache
// lane, slot) pairs the ancestry names, once each: at the main path's
// shape (96 items x 4 beams, 16 heads x 64 dims, slot 31, bf16) 3,987
// pairs x 16 heads x 128 B x 2 (K and V) = 16 MB, 0.0056 ms at 3.35 TB/s.
// The work, ~4 FLOP per (beam, head, slot, dim), is ~50 MFLOP: negligible.
// PR 2's kernel (a block per beam, a warp per head walking the slots) read
// each shared row once per beam and waited on a chain of dependent steps
// per slot: a memory round trip every four slots, a warp reduction and the
// online-softmax rescale every slot.
//
// Design (the launch plan: ops/beam_attn.py `plan`):
// - A block per (item, group of its beams, group of heads), a warp per
//   (beam, head), a lane per slot of a chunk of up to 32 slots.
// - Each lane reads the ancestry of its slot for every beam of the group.
//   The row a beam names at a slot is staged in shared memory at [the
//   first beam of the group naming the same cache lane][slot]: that beam's
//   warps copy it (each its head's 16-byte pieces, `cp.async`; int8
//   scales as 4-byte copies), every beam reads it there. So a row shared by
//   beams is read from device memory once per item, with no pass that
//   numbers the distinct rows. The stage holds a row per (beam, slot), the
//   worst case; chunking bounds it for every T. Rows whose bytes are not a
//   multiple of 16 (or a base not 16-byte aligned) are copied element by
//   element, zero-filled to the staged width.
// - No serial chain: each lane computes its slot's score as one dot from
//   shared memory, the warp takes the softmax terms with two reductions and
//   merges them into the running max and sum (online across chunks), and
//   the context is summed over slots with lanes spread over (slot group,
//   8-value unit of the row). An int8 cache is dequantised as it is used:
//   the K scale multiplies the dot, the V scale the softmax weight.
// - The next chunk's ancestry is loaded while a chunk computes.
// - Deterministic: every sum runs in a fixed order, no atomics, so a
//   relaunch is bit-identical.
// - A programmatic dependent launch: the blocks may start while the
//   previous kernel of the stream finishes (`griddepcontrol.wait` first).
// What holds it above the bound (tools/k3_probe.py, PERF.md): a block's
// chain (the ancestry and queries, then the rows, then the compute) runs
// in more than one wave of blocks, since a warp per (beam, head) needs
// 6,144 warps at the beam path's shape and at 64 registers a thread the
// card holds 4,224 at once.
// Output is f32, as the Pallas kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeads = 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxBeamsPerBlock = 8;
constexpr int kMaxPairs = 16;  // (beam, head) pairs a block: a warp each
constexpr unsigned kMaxSmem = 232448;  // 227 KB a block on the H100

__host__ __device__ inline unsigned align16(unsigned x) { return (x + 15u) & ~15u; }

// Shared-memory layout of a block, in bytes (host and device agree).
struct Layout {
  int rs;     // bytes of one head's staged row: d * elem rounded up to 16
  int pitch;  // bytes from one staged row to the next (all heads, padded so
              // that eight consecutive rows' 16-byte pieces fall in distinct banks)
  int qrow;   // bytes of a staged query: rs / elem f32 values (zero past d)
  unsigned stage, scale, q, wr, total;
};

__host__ __device__ inline Layout make_layout(int elem, bool quant, int d, int kg, int hg,
                                              int s) {
  Layout L;
  L.rs = (d * elem + 15) / 16 * 16;
  L.pitch = hg * L.rs + ((hg * L.rs / 16) % 2 == 0 ? 16 : 0);
  L.qrow = align16(L.rs / elem * 4);
  const unsigned rows = s * kg;  // a row per (beam, slot) at most
  unsigned o = 0;
  L.stage = o;  // [K, V][beam][slot][pitch]: the row beam k's ancestry names
                // at slot t sits at [first beam naming it][t]
  o += 2u * rows * L.pitch;
  L.scale = o;  // [K, V][beam][slot][head] f32, int8 only
  o += quant ? align16(2u * rows * hg * 4) : 0;
  L.q = o;  // [pair][qrow]
  o += kg * hg * L.qrow;
  L.wr = o;  // [pair][slot] (softmax weight, staged row) of a chunk
  o += kg * hg * kWarp * 8u;
  L.total = o;
  return L;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* anc;
  float* out;
  int q_kind, bk, heads, t_total, d, k_beams, t0, slot;
  float scale;
  int kg, hg;  // beams and heads per block
  int s;       // slots a chunk
  int lpr;     // lanes per row in the context sum (its 8-value units, to a
               // power of two)
  int vec;     // rows copied as 16-byte pieces (else element by element)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the two bf16 halves of a 32-bit word as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The N values at p as f32: N * sizeof(T) is 8 bytes (p 8-byte aligned) or
// a multiple of 16 (p 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&x)[N]) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t c[kWords];
  if constexpr (kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      c[4 * i] = u.x;
      c[4 * i + 1] = u.y;
      c[4 * i + 2] = u.z;
      c[4 * i + 3] = u.w;
    }
  } else {
    static_assert(kWords == 2, "8 bytes or a multiple of 16");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    c[0] = u.x;
    c[1] = u.y;
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if constexpr (std::is_same<T, float>::value) {
      x[w] = __uint_as_float(c[w]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[2 * w] = bf16_lo(c[w]);
      x[2 * w + 1] = bf16_hi(c[w]);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * w + b] = static_cast<float>(static_cast<int8_t>(c[w] >> (8 * b)));
    }
  }
}

template <typename T>
using Bits = typename std::conditional<
    sizeof(T) == 4, uint32_t,
    typename std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type>::type;

// At most 64 registers a thread (two blocks of 512 threads an SM): more
// blocks resident at once, which measured 1-3 us faster a launch than the
// compiler's own choice (80-128 registers) at the beam path's shapes.
template <typename T>
__global__ void __launch_bounds__(kWarp * kMaxPairs, 2) beam_attn_kernel(Args a) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int kVec = 16 / sizeof(T);         // values in a 16-byte piece of a row
  constexpr int kCv = kVec > 8 ? 8 : kVec;     // values a lane sums in the context
  // launched as a programmatic dependent launch: every memory access waits
  // here until the previous kernel of the stream has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(sizeof(T), kQuant, a.d, a.kg, a.hg, a.s);

  // block -> (item, beam group, head group), the head groups of an item adjacent
  const int n_hg = (a.heads + a.hg - 1) / a.hg;
  const int n_kg = (a.k_beams + a.kg - 1) / a.kg;
  const int rest = blockIdx.x / n_hg;
  const int item_lane0 = (rest / n_kg) * a.k_beams;
  const int k0 = (rest % n_kg) * a.kg, kga = min(a.kg, a.k_beams - k0);
  const int h0 = (blockIdx.x % n_hg) * a.hg, hga = min(a.hg, a.heads - h0);
  // a warp per (beam, head) pair; warps past the group's pairs stay idle
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int pairs = kga * hga;
  const int kk = warp / hga, hh = warp - kk * hga;
  const bool owner = warp < pairs;

  // the ancestry of the lane's slot in the first chunk, for every beam of
  // the group (a lane per slot), and the queries (f32, zero past d)
  const int* anc_base = a.anc + static_cast<size_t>(item_lane0 + k0) * a.t_total + a.t0 + lane;
  int src[kMaxBeamsPerBlock];
#pragma unroll
  for (int j = 0; j < kMaxBeamsPerBlock; ++j)
    src[j] = (owner && j < kga && lane < min(a.s, a.slot + 1 - a.t0))
                 ? anc_base[static_cast<size_t>(j) * a.t_total]
                 : -1;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  const int qd = L.qrow / 4;
  for (int i = threadIdx.x; i < pairs * qd; i += blockDim.x) {
    const int p = i / qd, e = i - p * qd;
    const int pk = p / hga, ph = p - pk * hga;
    float x = 0.0f;
    if (e < a.d) {
      const size_t off = (static_cast<size_t>(item_lane0 + k0 + pk) * a.heads + h0 + ph) * a.d + e;
      x = a.q_kind == 0 ? static_cast<const float*>(a.q)[off]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off]);
    }
    qs[i] = x;  // seen after the first chunk's barrier
  }

  // the context: lane (g, u) sums 8-value unit u (4 for f32) of every
  // groups-th slot's V row from slot g
  const int groups = kWarp / a.lpr, g = lane / a.lpr, u = lane % a.lpr;
  const int units = L.rs / static_cast<int>(kCv * sizeof(T));
  float acc[kCv];
#pragma unroll
  for (int j = 0; j < kCv; ++j) acc[j] = 0.0f;
  float m_run = -INFINITY;  // running max of the scores
  float l_run = 0.0f;       // running sum of exp(score - m_run)
  const float* q = qs + warp * qd;
  float2* wr = reinterpret_cast<float2*>(smem + L.wr) + warp * kWarp;
  const size_t kv_stage = static_cast<size_t>(a.s) * a.kg * L.pitch;  // K to V
  float* scales = reinterpret_cast<float*>(smem + L.scale);

  for (int tc = a.t0; tc <= a.slot; tc += a.s) {
    const int ns = min(a.s, a.slot + 1 - tc);
    const bool valid = owner && lane < ns;
    // the first beam of the group whose ancestry names the same row: that
    // beam's warps copy it (each its own head), every beam reads it there
    int mine = -1;  // the cache beam the warp's beam reads at the lane's slot
#pragma unroll
    for (int j = 0; j < kMaxBeamsPerBlock; ++j)
      if (j == kk) mine = src[j];
    int first = 0;
#pragma unroll
    for (int j = kMaxBeamsPerBlock - 1; j >= 0; --j)
      if (j < kga && src[j] == mine) first = j;
    const int pos = first * a.s + lane;  // staged row of the lane's slot
    if (valid && first == kk) {
      const size_t grow =
          (static_cast<size_t>(h0 + hh) * a.bk + item_lane0 + mine) * a.t_total + tc + lane;
      unsigned char* dst = smem + L.stage + static_cast<size_t>(pos) * L.pitch + hh * L.rs;
      const T* ksrc = static_cast<const T*>(a.k) + grow * a.d;
      const T* vsrc = static_cast<const T*>(a.v) + grow * a.d;
      if (a.vec) {
        for (int piece = 0; piece < L.rs / 16; ++piece) {
          cp_async16(dst + piece * 16, ksrc + piece * kVec);
          cp_async16(dst + kv_stage + piece * 16, vsrc + piece * kVec);
        }
      } else {
        for (int e = 0; e < L.rs / static_cast<int>(sizeof(T)); ++e) {
          reinterpret_cast<Bits<T>*>(dst)[e] =
              e < a.d ? reinterpret_cast<const Bits<T>*>(ksrc)[e] : Bits<T>(0);
          reinterpret_cast<Bits<T>*>(dst + kv_stage)[e] =
              e < a.d ? reinterpret_cast<const Bits<T>*>(vsrc)[e] : Bits<T>(0);
        }
      }
      if constexpr (kQuant) {
        cp_async4(scales + pos * a.hg + hh, a.k_scale + grow);
        cp_async4(scales + (a.s * a.kg + pos) * a.hg + hh, a.v_scale + grow);
      }
    }
    cp_async_commit();
    // the next chunk's ancestry, in flight while this one computes
    const int tn = tc + a.s;
#pragma unroll
    for (int j = 0; j < kMaxBeamsPerBlock; ++j)
      src[j] = (owner && j < kga && lane < min(a.s, a.slot + 1 - tn))
                   ? anc_base[static_cast<size_t>(j) * a.t_total + (tn - a.t0)]
                   : -1;
    cp_async_wait_all();
    __syncthreads();

    if (owner) {
      // scores: a lane per slot
      const unsigned char* krow = smem + L.stage + static_cast<size_t>(pos) * L.pitch + hh * L.rs;
      float s = -INFINITY;
      if (valid) {
        float dot = 0.0f;
#pragma unroll 4
        for (int piece = 0; piece < L.rs / 16; ++piece) {
          float kx[kVec], qx[kVec];
          load_f32<T, kVec>(reinterpret_cast<const T*>(krow) + piece * kVec, kx);
          load_f32<float, kVec>(q + piece * kVec, qx);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot += kx[j] * qx[j];
        }
        s = dot * a.scale;
        if constexpr (kQuant) s *= scales[pos * a.hg + hh];
      }
      // the chunk's softmax terms, merged into the running max and sum
      float mx = s;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);  // 0 on the first chunk (m_run = -inf)
      float w = valid ? expf(s - m_new) : 0.0f;
      float sum = w;
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if constexpr (kQuant) {
        if (valid) w *= scales[(a.s * a.kg + pos) * a.hg + hh];
      }
      if (valid) wr[lane] = make_float2(w, __int_as_float(pos));
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kCv; ++j) acc[j] *= corr;
      if (u < units) {
        const unsigned char* vbase = smem + L.stage + kv_stage + hh * L.rs + u * kCv * sizeof(T);
#pragma unroll 4
        for (int t = g; t < ns; t += groups) {
          const float2 e = wr[t];
          float vx[kCv];
          load_f32<T, kCv>(reinterpret_cast<const T*>(
                               vbase + static_cast<size_t>(__float_as_int(e.y)) * L.pitch),
                           vx);
#pragma unroll
          for (int j = 0; j < kCv; ++j) acc[j] += e.x * vx[j];
        }
      }
      __syncwarp();
    }
    if (tn <= a.slot) __syncthreads();  // the stage is refilled next
  }

  if (owner) {
    // sum the slot groups (lanes of equal u), then write
#pragma unroll
    for (int off = a.lpr; off < kWarp; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kCv; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    }
    if (g == 0 && u < units) {
      const float inv = 1.0f / l_run;
      float* o = a.out + (static_cast<size_t>(item_lane0 + k0 + kk) * a.heads + h0 + hh) * a.d;
#pragma unroll
      for (int j = 0; j < kCv; ++j) {
        const int e = u * kCv + j;
        if (e < a.d) o[e] = acc[j] * inv;
      }
    }
  }
}

int elem_size(int kv_kind) { return kv_kind == 0 ? 4 : kv_kind == 1 ? 2 : 1; }

template <typename T>
int launch(const Args& a, int blocks, int threads, unsigned smem, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be allowed once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48u * 1024u && dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(beam_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // the launch overlaps the previous kernel's tail (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, beam_attn_kernel<T>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block of a plan (kv_kind 0: f32, 1: bf16,
// 2: int8; d head dims; beams and heads a block, slots a chunk).
extern "C" int rgrg_beam_attention_smem(int kv_kind, int d, int beams, int heads, int slots) {
  return static_cast<int>(make_layout(elem_size(kv_kind), kv_kind == 2, d, beams, heads, slots).total);
}

// q [bk, heads, d] (q_kind 0: f32, 1: bf16); k, v [heads, bk, t_total, d]
// (kv_kind 0: f32, 1: bf16, 2: int8 with k_scale/v_scale [heads, bk,
// t_total] f32); anc [bk, t_total] int32 ancestor beams (0..k_beams-1);
// out [bk, heads, d] f32; all contiguous. Attends over slots t0..slot.
// The plan: a block per item's group of `beams` beams and group of
// `heads_per_block` heads (at most 8 beams and 16 pairs: a warp per pair,
// so 32 * beams * heads threads), chunks of `slots` slots (1..32).
// Allocates nothing. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int rgrg_beam_attention(const void* q, int q_kind, const void* k, const void* v,
                                   int kv_kind, const void* k_scale, const void* v_scale,
                                   const void* anc, void* out, int bk, int heads, int t_total,
                                   int d, int k_beams, int t0, int slot, float scale, int beams,
                                   int heads_per_block, int slots, void* stream) {
  if (bk <= 0 || heads <= 0 || heads > kMaxHeads || d <= 0 || d > kMaxHeadDim ||
      k_beams <= 0 || bk % k_beams != 0 || t0 < 0 || t0 > slot || slot >= t_total ||
      q_kind < 0 || q_kind > 1 || kv_kind < 0 || kv_kind > 2 ||
      (kv_kind == 2 && (k_scale == nullptr || v_scale == nullptr)) || beams < 1 ||
      beams > kMaxBeamsPerBlock || beams > k_beams || heads_per_block < 1 ||
      heads_per_block > heads || beams * heads_per_block > kMaxPairs || slots < 1 ||
      slots > kWarp) {
    return cudaErrorInvalidValue;
  }
  const int elem = elem_size(kv_kind);
  const Layout L = make_layout(elem, kv_kind == 2, d, beams, heads_per_block, slots);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.anc = static_cast<const int*>(anc);
  a.out = static_cast<float*>(out);
  a.q_kind = q_kind;
  a.bk = bk;
  a.heads = heads;
  a.t_total = t_total;
  a.d = d;
  a.k_beams = k_beams;
  a.t0 = t0;
  a.slot = slot;
  a.scale = scale;
  a.kg = beams;
  a.hg = heads_per_block;
  a.s = slots;
  const int cv_bytes = (elem == 1 ? 8 : 16);  // a context unit: 8 values (4 f32)
  a.lpr = 1;
  while (a.lpr * cv_bytes < L.rs) a.lpr *= 2;
  a.vec = (d * elem) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  const int blocks = bk / k_beams * ((k_beams + beams - 1) / beams) *
                     ((heads + heads_per_block - 1) / heads_per_block);
  const int threads = kWarp * beams * heads_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return launch<float>(a, blocks, threads, L.total, s);
    case 1:
      return launch<__nv_bfloat16>(a, blocks, threads, L.total, s);
    default:
      return launch<int8_t>(a, blocks, threads, L.total, s);
  }
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
