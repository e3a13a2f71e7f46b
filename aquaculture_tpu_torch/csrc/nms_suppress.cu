// Exact batched greedy NMS suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_suppress_kernel`
// (aquaculture_tpu/ops/nms_pallas.py:33, launched by greedy_suppress_pallas).
// Semantics: boxes (B, K, 4) score-sorted xyxy f32 (class offsets already
// added for class-aware NMS), valid (B, K) bool -> keep (B, K) bool.
// Candidate g suppresses every later j with IoU(g, j) > thr, but only if g
// itself survived, so the K steps are serial. IoU is the f32 formula of
// aquaculture_tpu/ops/nms.py:24-32:
//   inter / max(union, 1e-9) where union > 0, else 0,
//   union = (area_g + area_j) - inter.
//
// What bounds it on the H100: not bytes (18 B per candidate: 16 B of box,
// 1 B valid in, 1 B keep out) and hardly the IoU arithmetic (at most
// K^2/2 IoUs per image, a few microseconds of the card's f32 rate at
// B=128, K=1024), but the serial dependency: K steps, each a barrier plus
// one IoU row. The design follows from that:
//   * one CTA per image, so the B scans run side by side on the SMs and no
//     step ever leaves the chip;
//   * the image's boxes, areas and the keep flags live in shared memory
//     (21 B per candidate), so a step touches no device memory;
//   * a step whose candidate is already suppressed is one barrier and one
//     shared-memory read: the branch is uniform over the block.
// The TPU kernel's (K, B) lane layout, 8-row blocks and 128-image split are
// TPU layout rules and are not carried over. A pre-built parallel bitmask
// of the causal IoU mask is the known next step for speed.
//
// Exactness: build with -fmad=false (keeps `area_g + area_j - w*h` from
// contracting into an FMA) and the default IEEE division (-prec-div=true);
// no --use_fast_math. Either could flip an `iou > thr` decision at the
// boundary against the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Shared memory per candidate: 5 floats (x0, y0, x1, y1, area) + 1 flag.
constexpr int kBytesPerCandidate = 5 * 4 + 1;
// 8192 * 21 B = 172,032 B, inside the 227 KB a Hopper block may use.
constexpr int kMaxK = 8192;

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, float iou_thresh) {
  extern __shared__ float smem[];
  float* x0 = smem;
  float* y0 = x0 + k;
  float* x1 = y0 + k;
  float* y1 = x1 + k;
  float* area = y1 + k;
  uint8_t* alive = reinterpret_cast<uint8_t*>(area + k);

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const float4 b = boxes[base + j];
    x0[j] = b.x;
    y0[j] = b.y;
    x1[j] = b.z;
    y1[j] = b.w;
    area[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    alive[j] = valid[base + j] != 0;
  }

  for (int g = 0; g < k; ++g) {
    // keep[g] is final once every write of steps < g is visible.
    __syncthreads();
    if (!alive[g]) continue;  // uniform: every thread reads the same flag
    const float gx0 = x0[g], gy0 = y0[g], gx1 = x1[g], gy1 = y1[g];
    const float garea = area[g];
    for (int j = g + 1 + threadIdx.x; j < k; j += kThreads) {
      if (!alive[j]) continue;
      const float w = fmaxf(fminf(gx1, x1[j]) - fmaxf(gx0, x0[j]), 0.0f);
      const float h = fmaxf(fminf(gy1, y1[j]) - fmaxf(gy0, y0[j]), 0.0f);
      const float inter = w * h;
      const float uni = garea + area[j] - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
      if (iou > iou_thresh) alive[j] = 0;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) keep[base + j] = alive[j];
}

}  // namespace

extern "C" {

int aq_nms_max_k() { return kMaxK; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller has checked shapes, alignment and 1 <= k <= kMaxK, b >= 1.
int aq_nms_suppress(const void* boxes, const void* valid, void* keep, int b,
                    int k, float iou_thresh, void* stream) {
  if (k < 1 || k > kMaxK || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * kBytesPerCandidate;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_suppress_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
