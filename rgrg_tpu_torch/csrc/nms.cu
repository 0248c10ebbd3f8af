// Greedy non-maximum suppression keep mask: a suppression bitmask, then a
// sweep with only bit operations.
//
// Replaces: rgrg_tpu/ops/nms_pallas.py `_nms_kernel` (entry
// `nms_keep_mask_pallas`), the TPU kernel that resolves greedy NMS over
// score-sorted proposals with a per-tile fixpoint plus one [T, N] masked max.
//
// What bounds it on the H100: not bytes and not FLOPs. An image moves
// 18 bytes per box (16 in, 1 valid, 1 keep) and the IoU tests of 1000 boxes
// are a few MFLOP, both well under a microsecond. Greedy NMS is a chain of
// N dependent decisions, so the bound is the latency of that chain.
//
// Design: two launches on one stream.
// - Words (`nms_keep_mask_kernel_words`): one block of 64 threads per
//   (image, row group of 64 boxes, column group of 64 boxes at or after the
//   row group). The column group's boxes are staged in shared memory; the
//   thread of box i writes one 64-bit word, words[b][i][g], whose bit k is
//   set iff box j = 64 g + k comes after i and i suppresses j. All IoU tests
//   of the image run at once, on many SMs; none waits for a decision. Words
//   of column groups before the row group are not written: no box of an
//   earlier group comes after i, and the sweep never reads them.
// - Sweep (`nms_keep_mask_kernel_sweep`): one warp per image. Lane w holds
//   the removed-word of group w (at most 32 groups, N <= 2048), started
//   from ~valid, so an invalid box is never kept and never suppresses. For
//   group g, lane g resolves the group's 64 decisions in registers from the
//   diagonal words (box i is kept iff its bit is clear; a kept box ORs its
//   diagonal word in), the keep bits go to every lane by a shuffle, and
//   every lane w > g ORs word w of each kept box. The next group's rows
//   are copied into shared memory (`cp.async`) while the warp resolves
//   this one. The chain is one register step per box (on the 32-bit half
//   that holds the box's bit) and a shuffle per group, with no block-wide
//   barrier.
//
// Exactness: the keep mask must equal the f32 reference bit for bit, so the
// IoU uses the reference's formula and operation order,
//   inter / ((area_a + area_b) - inter),
// with a the earlier box, round-to-nearest intrinsics and no epsilon; the
// file is also built with -fmad=false. A contracted `area_a + area_b -
// inter` would flip decisions at IoU ~ 0.7. Zero-area pairs give 0/0 = NaN,
// and NaN > t is false, so they set no bit. A pair that does not overlap
// has IoU 0 (or NaN), above no threshold >= 0, and skips the division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 2048;
constexpr int kGroup = 64;  // boxes per word
constexpr unsigned kFull = 0xffffffffu;

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
  // no overlap: the IoU is 0 (or NaN), above no threshold >= 0; the
  // division, the costly step, is skipped
  if (inter == 0.0f && thr >= 0.0f) return false;
  const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
  return iou > thr;
}

// grid: (groups * (groups + 1) / 2 (row group, column group >= row group), batch)
__global__ void __launch_bounds__(kGroup)
nms_keep_mask_kernel_words(const float* __restrict__ boxes,
                           uint64_t* __restrict__ words, int n, int groups,
                           float thr) {
  __shared__ float4 col[kGroup];

  int t = blockIdx.x;
  int rg = 0;
  while (t >= groups - rg) {
    t -= groups - rg;
    ++rg;
  }
  const int cg = rg + t;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const int lane = threadIdx.x;

  const int j = cg * kGroup + lane;
  if (j < n) {
    const float* bj = boxes + (base + j) * 4;
    col[lane] = make_float4(bj[0], bj[1], bj[2], bj[3]);
  }
  __syncthreads();

  const int i = rg * kGroup + lane;
  if (i >= n) return;
  const float* a = boxes + (base + i) * 4;
  const float ax1 = a[0], ay1 = a[1], ax2 = a[2], ay2 = a[3];
  const int first = cg == rg ? lane + 1 : 0;
  const int last = min(kGroup, n - cg * kGroup);
  uint64_t word = 0;
#pragma unroll 4
  for (int k = first; k < last; ++k) {
    const float4 bk = col[k];
    if (suppresses(ax1, ay1, ax2, ay2, bk.x, bk.y, bk.z, bk.w, thr)) word |= 1ull << k;
  }
  words[(base + i) * groups + cg] = word;
}

__device__ __forceinline__ void copy8_async(uint64_t* dst, const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy16_async(uint64_t* dst, const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copies the rows of group g (one contiguous span of words) into `dst`:
// 16 bytes a copy when the span and `dst` are 16-byte aligned.
__device__ __forceinline__ void prefetch_group(uint64_t* dst, const uint64_t* w,
                                               int g, int n, int groups, int lane) {
  const int count = min(kGroup, n - g * kGroup) * groups;
  const uint64_t* src = w + static_cast<size_t>(g) * kGroup * groups;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    for (int e = 2 * lane; e + 1 < count; e += 64) copy16_async(dst + e, src + e);
    if ((count & 1) && lane == 0) copy8_async(dst + count - 1, src + count - 1);
  } else {
    for (int e = lane; e < count; e += 32) copy8_async(dst + e, src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// grid: batch blocks of one warp; dynamic shared memory 2 x 64 x groups words
__global__ void __launch_bounds__(32)
nms_keep_mask_kernel_sweep(const uint64_t* __restrict__ words,
                           const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ keep, int n, int groups) {
  extern __shared__ __align__(16) uint64_t rows[];  // [2][kGroup][groups]

  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint64_t* w = words + base * groups;
  const int stage = kGroup * groups;  // words of one group's rows

  prefetch_group(rows, w, 0, n, groups, lane);

  // lane g's removed-word: its group's invalid boxes and the slots past n
  uint64_t ok = 0;
  if (lane < groups) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int j = lane * kGroup + k;
      if (j < n && valid[base + j]) ok |= 1ull << k;
    }
  }
  uint64_t removed = ~ok;

  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups) {
      prefetch_group(rows + ((g + 1) & 1) * stage, w, g + 1, n, groups, lane);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();  // every lane's copies of group g have landed
    const uint64_t* r = rows + (g & 1) * stage;
    const int cnt = min(kGroup, n - g * kGroup);

    uint64_t kept = 0;
    if (lane == g) {
      // A box's diagonal word only has bits of later boxes, so the bits
      // still clear at the end are the kept boxes (slots past n start set).
      // Unrolled, every shift is a constant, and the chain runs on the
      // 32-bit half that holds the box's own bit.
      uint32_t lo = static_cast<uint32_t>(removed);
      uint32_t hi = static_cast<uint32_t>(removed >> 32);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const uint64_t d = i < cnt ? r[i * groups + g] : 0;
        const bool gone = i < 32 ? (lo >> i) & 1 : (hi >> (i - 32)) & 1;
        if (!gone) {
          lo |= static_cast<uint32_t>(d);
          hi |= static_cast<uint32_t>(d >> 32);
        }
      }
      kept = ~((static_cast<uint64_t>(hi) << 32) | lo);
    }
    kept = __shfl_sync(kFull, static_cast<unsigned long long>(kept), g);

    if (lane > g && lane < groups) {
      // independent reads of the kept rows' words, no chain
      uint64_t rm = removed;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if ((kept >> i) & 1) rm |= r[i * groups + lane];
      removed = rm;
    }
    const int j0 = g * kGroup + lane, j1 = j0 + 32;
    if (j0 < n) keep[base + j0] = (kept >> lane) & 1;
    if (j1 < n) keep[base + j1] = (kept >> (lane + 32)) & 1;
    __syncwarp();  // stage g & 1 is refilled with group g + 2 next
  }
}

int groups_of(int n) { return (n + kGroup - 1) / kGroup; }

cudaError_t launch_words(const void* boxes, void* words, int batch, int n,
                         float thr, cudaStream_t s) {
  const int groups = groups_of(n);
  const dim3 grid(groups * (groups + 1) / 2, batch);
  nms_keep_mask_kernel_words<<<grid, kGroup, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<uint64_t*>(words), n, groups, thr);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n) {
  return batch <= 0 || batch > 65535 || n <= 0 || n > kMaxBoxes;
}

}  // namespace

// boxes [batch, n, 4] f32 -> words [batch, n, ceil(n / 64)] uint64, the
// suppression bitmask alone (words of column groups before a box's own
// group are left as they are). Returns the CUDA error code of the launch.
extern "C" int rgrg_nms_words(const void* boxes, void* words, int batch, int n,
                              float thr, void* stream) {
  if (bad_shape(batch, n)) return cudaErrorInvalidValue;
  return static_cast<int>(
      launch_words(boxes, words, batch, n, thr, static_cast<cudaStream_t>(stream)));
}

// boxes [batch, n, 4] f32, valid/keep [batch, n] bool (1 byte), words a
// scratch of batch x n x ceil(n / 64) uint64, all contiguous. Two launches
// on `stream`. Returns the CUDA error code of the launches (0 on success).
extern "C" int rgrg_nms_keep_mask(const void* boxes, const void* valid,
                                  void* keep, void* words, int batch, int n,
                                  float thr, void* stream) {
  if (bad_shape(batch, n)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_words(boxes, words, batch, n, thr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = groups_of(n);
  const size_t smem = 2 * kGroup * groups * sizeof(uint64_t);
  nms_keep_mask_kernel_sweep<<<batch, 32, smem, s>>>(
      static_cast<const uint64_t*>(words), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rgrg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
