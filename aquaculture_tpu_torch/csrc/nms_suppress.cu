// Exact batched greedy NMS suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_suppress_kernel`
// (aquaculture_tpu/ops/nms_pallas.py:33, launched by greedy_suppress_pallas).
// Semantics: boxes (B, K, 4) score-sorted xyxy f32 (class offsets already
// added for class-aware NMS), valid (B, K) bool -> keep (B, K) bool.
// Candidate g suppresses every later j with IoU(g, j) > thr, but only if g
// itself survived, so the K decisions form a serial chain. IoU is the f32
// formula of aquaculture_tpu/ops/nms.py:24-32, with the earlier candidate
// g as the first operand everywhere, as in the reference's row g:
//   inter / max(union, 1e-9) where union > 0, else 0,
//   union = (area_g + area_j) - inter.
//
// What bounds it on the H100: not bytes (18 B per candidate: 16 B of box,
// 1 B valid in, 1 B keep out) and not the card's f32 rate (the IoUs this
// data needs take about a microsecond of it at B=128, K=1024), but one SM's
// issue rate on the serial chain: one CTA per image, so the B scans run side
// by side and each image's work is bounded by what one SM can issue between
// the chain's steps. The design resolves the chain 32 candidates (one
// "word") at a time, in bits, with the whole CTA on the IoUs:
//   * 512 threads (16 warps) per CTA. 256 leave the SM's four schedulers
//     short of warps; 1024 cap registers at 64 and spill;
//   * prologue, fully parallel: the alive bitset (one __ballot_sync per
//     word) and every word's 32 in-block row words m_i (bit c set when
//     IoU(i, c) > thr, c > i in the same word);
//   * word t is resolved by one warp: the 32-step greedy chain on bits
//     (kept_i = !removed_i; if kept_i, removed |= m_i) gives the kept word,
//     and the kept boxes and their areas are packed into a 32-entry table;
//   * step t: each warp takes the later words t+1+w, t+17+w, ... that still
//     have an alive bit; each lane tests its alive candidate against the
//     table's kept boxes (two independent IoUs per pass), __ballot_sync
//     forms the word's suppressed bits and one lane clears them (one warp
//     per word, no atomics). Warp 0, which took word t+1, then resolves it
//     into the other half of a double-buffered table while the others
//     finish; one __syncthreads() ends the step. A word with no alive bit
//     costs one shared-memory read and no barrier (the word after it is
//     resolved behind one extra barrier);
//   * so an image pays at most 2 * ceil(K/32) + 2 barriers, and
//     ceil(K/32) + 3 when no word is empty: 35 at K=1024.
// Shared memory holds the row words and bitsets (4.25 B per candidate)
// always, and the boxes (16 B per candidate) while the total fits the
// 227 KB a block may use (K <= kMaxStagedK, 11,392). Above that the boxes
// are read from device memory, where 25,200 x 16 B per image sits in the
// 50 MB L2. Areas are computed from the boxes by the reference formula,
// never stored per candidate. The TPU kernel's (K, B) lane layout, 8-row
// blocks and 128-image split are TPU layout rules and are not carried over.
//
// Exactness. The decision iou > thr needs the correctly rounded f32
// quotient q' = RN(inter / den), den = max(union, 1e-9), and IEEE division
// is a long branchy sequence on the GPU. It is decided without dividing:
// with mid the midpoint between thr and the next float above it,
//   RN(q) > thr  <=>  q > mid, or q == mid and the next float is even
// (RN ties to even). q > mid is tested as inter > mid * den in double: mid
// has at most 25 significant bits and den 24, so the product is exact,
// and so is the comparison. The host computes mid from thr. The kernel is
// built with -fmad=false (keeps `area_g + area_j - w*h` from contracting
// into an FMA); no --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;
// Shared memory a Hopper block may use (dynamic, after opting in).
constexpr size_t kSmemBytes = 232448;
// 1536 words: row words and bitsets fill 210,176 B. Covers every P5 pool
// at 640 px (25,200 rows) with room.
constexpr int kMaxK = 49152;

// RN(q) > thr  <=>  q > mid, or q == mid and tie_up.
struct Threshold {
  double mid;
  int tie_up;
};

// Dynamic shared memory for `words` 32-candidate words: staged boxes, the
// kept table (2 x 32 boxes), row words, kept areas (2 x 32), and the alive
// and kept bitsets.
__host__ __device__ constexpr size_t smem_bytes(int words, bool staged) {
  return (staged ? static_cast<size_t>(words) * 32 * 16 : 0) + 64 * 16 +
         static_cast<size_t>(words) * 32 * 4 + 64 * 4 + static_cast<size_t>(words) * 2 * 4;
}
static_assert(smem_bytes(kMaxK / 32, false) <= kSmemBytes, "kMaxK overflows shared memory");

constexpr int max_staged_k() {
  int words = kMaxK / 32;
  while (smem_bytes(words, true) > kSmemBytes) --words;
  return 32 * words;
}
constexpr int kMaxStagedK = max_staged_k();

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// IoU(g, j) > thr for the reference's f32 IoU, g first (see Exactness).
__device__ __forceinline__ bool overlaps(float4 g, float garea, float4 j, float jarea,
                                         Threshold thr) {
  const float w = fmaxf(fminf(g.z, j.z) - fmaxf(g.x, j.x), 0.0f);
  const float h = fmaxf(fminf(g.w, j.w) - fmaxf(g.y, j.y), 0.0f);
  const float inter = w * h;
  const float uni = (garea + jarea) - inter;
  const bool pos = uni > 0.0f;  // else iou = 0: test 0 / 1
  const double num = pos ? inter : 0.0f;
  const double den = pos ? fmaxf(uni, 1e-9f) : 1.0f;
  const double rhs = thr.mid * den;
  return num > rhs || (thr.tie_up && num == rhs);
}

template <bool kStaged>
__device__ __forceinline__ float4 load_box(const float4* __restrict__ boxes, int j) {
  if constexpr (kStaged) {
    return boxes[j];
  } else {
    return __ldg(boxes + j);
  }
}

// The greedy chain of one word on bits: the kept word.
__device__ __forceinline__ uint32_t chain(const uint32_t* rows, uint32_t aw) {
  uint32_t removed = ~aw;
  uint32_t kw = 0;
  const uint4* r4 = reinterpret_cast<const uint4*>(rows);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 r = r4[q];
    const uint32_t m[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bit = 1u << (4 * q + e);
      if (!(removed & bit)) {
        kw |= bit;
        removed |= m[e];
      }
    }
  }
  return kw;
}

// One warp resolves word t (alive[t] is final): kept[t], and the kept boxes
// and areas packed into table half t & 1.
template <bool kStaged>
__device__ __forceinline__ void resolve(int t, const float4* box, const uint32_t* rows,
                                        const uint32_t* alive, uint32_t* kept, float4* kbox,
                                        float* karea, int lane) {
  const uint32_t aw = alive[t];
  const uint32_t kw = aw ? chain(rows + 32 * t, aw) : 0u;
  if ((kw >> lane) & 1u) {
    const int r = 32 * (t & 1) + __popc(kw & ((1u << lane) - 1u));
    const float4 b = load_box<kStaged>(box, 32 * t + lane);
    kbox[r] = b;
    karea[r] = box_area(b);
  }
  if (lane == 0) kept[t] = kw;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, Threshold thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float4* gbox = boxes + base;

  float4* sbox = reinterpret_cast<float4*>(smem);
  float4* kbox = sbox + (kStaged ? 32 * words : 0);
  uint32_t* rows = reinterpret_cast<uint32_t*>(kbox + 64);
  float* karea = reinterpret_cast<float*>(rows + 32 * words);
  uint32_t* alive = reinterpret_cast<uint32_t*>(karea + 64);
  uint32_t* kept = alive + words;
  const float4* box = kStaged ? sbox : gbox;

  // Prologue 1: alive bitset, kept words cleared, boxes staged.
  for (int u = warp; u < words; u += kWarps) {
    const int j = 32 * u + lane;
    const uint32_t w = __ballot_sync(kFull, j < k && valid[base + j] != 0);
    if (lane == 0) {
      alive[u] = w;
      kept[u] = 0;
    }
  }
  if constexpr (kStaged) {
    for (int j = threadIdx.x; j < k; j += kThreads) sbox[j] = gbox[j];
  }
  __syncthreads();

  // Prologue 2: in-block row words of every word with an alive bit. Lane i
  // holds candidate 32u+i and takes each later candidate c of the word by
  // shuffle. Rows past K are computed on a zero box; their bits are never
  // alive, so the chain never reads them.
  for (int u = warp; u < words; u += kWarps) {
    if (alive[u] == 0) continue;  // uniform over the warp
    const int i = 32 * u + lane;
    const float4 bi = i < k ? load_box<kStaged>(box, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ai = box_area(bi);
    uint32_t m = 0;
#pragma unroll
    for (int c = 1; c < 32; ++c) {
      const float4 bc = make_float4(__shfl_sync(kFull, bi.x, c), __shfl_sync(kFull, bi.y, c),
                                    __shfl_sync(kFull, bi.z, c), __shfl_sync(kFull, bi.w, c));
      m |= static_cast<uint32_t>((lane < c) & overlaps(bi, ai, bc, box_area(bc), thr)) << c;
    }
    rows[i] = m;
  }
  __syncthreads();

  int prev = -2;  // last word stepped; uniform over the CTA
  for (int t = 0; t < words; ++t) {
    // alive[t] is final: its last writer ran before the barrier that closed
    // the last step.
    if (alive[t] == 0) continue;  // uniform over the CTA
    if (prev != t - 1) {          // no warp resolved word t during step t-1
      if (warp == 0) resolve<kStaged>(t, box, rows, alive, kept, kbox, karea, lane);
      __syncthreads();
    }
    prev = t;
    const int nk = __popc(kept[t]);
    const float4* kb = kbox + 32 * (t & 1);
    const float* ka = karea + 32 * (t & 1);
    for (int u = t + 1 + warp; u < words; u += kWarps) {
      const uint32_t w = alive[u];
      if (w == 0) continue;  // uniform over the warp
      const bool live = (w >> lane) & 1u;
      const float4 bj = load_box<kStaged>(box, live ? 32 * u + lane : 32 * u);
      const float aj = box_area(bj);
      bool sup = false;
      for (int e = 0; e < nk; e += 2) {  // uniform: nk is the same in every lane
        const int e1 = min(e + 1, nk - 1);
        sup |= overlaps(kb[e], ka[e], bj, aj, thr) | overlaps(kb[e1], ka[e1], bj, aj, thr);
      }
      const uint32_t s = __ballot_sync(kFull, sup && live);
      if (lane == 0 && s) alive[u] = w & ~s;
    }
    if (t + 1 < words && warp == 0) {
      __syncwarp();  // lane 0's clear of word t+1 is visible to the whole warp
      resolve<kStaged>(t + 1, box, rows, alive, kept, kbox, karea, lane);
    }
    __syncthreads();
  }

  // kept[] was last written before a barrier (or in the prologue).
  for (int j = threadIdx.x; j < k; j += kThreads) {
    keep[base + j] = (kept[j >> 5] >> (j & 31)) & 1u;
  }
}

template <bool kStaged>
int launch(const void* boxes, const void* valid, void* keep, int b, int k, Threshold thr,
           cudaStream_t stream) {
  const size_t smem = smem_bytes((k + 31) / 32, kStaged);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nms_suppress_kernel<kStaged>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_suppress_kernel<kStaged><<<b, kThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int aq_nms_max_k() { return kMaxK; }

// Largest K whose boxes are staged in shared memory; above it the kernel
// reads them from device memory.
int aq_nms_max_staged_k() { return kMaxStagedK; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller has checked shapes, alignment and 1 <= k <= kMaxK, b >= 1.
int aq_nms_suppress(const void* boxes, const void* valid, void* keep, int b, int k,
                    float iou_thresh, void* stream) {
  if (k < 1 || k > kMaxK || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  // mid = (thr + next) / 2 is exact in double; above FLT_MAX the next
  // value is 2^128, where RN overflows to infinity.
  const float next = std::nextafter(iou_thresh, INFINITY);
  const double up = (std::isinf(next) && std::isfinite(iou_thresh)) ? std::ldexp(1.0, 128)
                                                                     : static_cast<double>(next);
  Threshold thr;
  thr.mid = 0.5 * (static_cast<double>(iou_thresh) + up);
  uint32_t bits;
  std::memcpy(&bits, &next, sizeof bits);
  thr.tie_up = (bits & 1u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kMaxStagedK) return launch<true>(boxes, valid, keep, b, k, thr, s);
  return launch<false>(boxes, valid, keep, b, k, thr, s);
}

}  // extern "C"
