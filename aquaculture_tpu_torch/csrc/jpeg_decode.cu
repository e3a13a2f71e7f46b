// JPEG reconstruction on the card: dequantisation + integer IDCT, then
// chroma upsampling + YCbCr->RGB + crop + the hard tile grid, as two
// hand-written kernels for sm_90a with a plain C interface (bound with ctypes
// by data/jpeg_cuda.py).
//
// Not a port of a TPU kernel: the JAX package decodes JPEG on host threads
// with libjpeg-turbo (its tileloader.cc, decode_jpeg). Here the host
// keeps the serial part, the Huffman entropy decode (csrc/jpeg_entropy.cc),
// and these kernels do the parallel part, writing the uint8 tiles straight
// into the device batch that the serving program reads. The arithmetic is
// libjpeg-turbo's, exactly: jpeg_idct_islow (8x8), jpeg_idct_5x5 and
// jpeg_idct_10x10 (5/8; 4:2:0 chroma takes the 10x10), libjpeg's range-limit
// table, jdsample.c's fancy upsampling, jdcolor.c's fixed-point tables. The
// plain versions are data/jpeg_plain.py's idct_batch_plain and
// color_batch_plain; chip_smoke.py holds these kernels against them with
// torch.equal.
//
// Bound: bytes. jpeg_idct_kernel reads each block's int16 coefficients
// once and writes its samples once; jpeg_color_kernel reads the planes and
// writes 3 bytes a pixel. A full decode of a 1024 px 4:2:0 tile moves ~9 MB
// in all, so a batch of 128 is bounded near 0.35 ms at 3.35 TB/s. This first
// version is simple: one thread per 8x8 block (IDCT in registers, byte
// stores to the plane) and one thread per output pixel (upsampling taps
// re-read from L1/L2). Shared-memory block tiles, coalesced plane stores and
// one fused pass are later work (ROADMAP.md).
//
// Descriptors, all int32 (data/jpeg_plain.py builds them):
//   comps  (8 per component of each image): coef_off, plane_off, blocks_w,
//          blocks_h, K, S, qt_off, plane_w
//   images (20 per image): ncomp, comp_base, out_w, out_h, color, then per
//          component: mode, h factor, v factor, downsampled w, downsampled h
//   tiles  (4 per batch slot): kind (0 zero, 1 decoded, 2 left to the
//          caller), image, x and y origin in decoded pixels

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int COMP_INTS = 8;
constexpr int IMAGE_INTS = 20;
constexpr int TILE_INTS = 4;

enum { UP_FULL = 0, UP_H2V1, UP_H1V2, UP_H2V2, UP_BOX };

#define FIX(x) ((int)((x) * (1 << CONST_BITS) + 0.5))

__device__ __forceinline__ int range_limit(int x) {
  int t = x & 1023;
  if (t >= 512) t -= 1024;
  t += 128;
  return t < 0 ? 0 : (t > 255 ? 255 : t);
}

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 8-point pass of jpeg_idct_islow, before its descale.
__device__ __forceinline__ void islow_1d(const int* z, int* o) {
  int z2 = z[2], z3 = z[6];
  int z1 = (z2 + z3) * 4433;
  int tmp2 = z1 + z3 * -15137;
  int tmp3 = z1 + z2 * 6270;
  int tmp0 = (z[0] + z[4]) * (1 << CONST_BITS);
  int tmp1 = (z[0] - z[4]) * (1 << CONST_BITS);
  int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int t0 = z[7], t1 = z[5], t2 = z[3], t3 = z[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int z4 = t1 + t3;
  int z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

// One 5-point pass of jpeg_idct_5x5; pass 1 shifts, pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct5_1d(const int* z, int* o) {
  int tmp12 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                     : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int tmp0 = z[2], tmp1 = z[4];
  int z1 = (tmp0 + tmp1) * FIX(0.790569415);
  int z2 = (tmp0 - tmp1) * FIX(0.353553391);
  int z3 = tmp12 + z2;
  int tmp10 = z3 + z1, tmp11 = z3 - z1;
  tmp12 -= z2 * 4;
  z2 = z[1];
  z3 = z[3];
  z1 = (z2 + z3) * FIX(0.831253876);
  tmp0 = z1 + z2 * FIX(0.513743148);
  tmp1 = z1 - z3 * FIX(2.176250899);
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp10 + tmp0) >> s;
  o[4] = (tmp10 - tmp0) >> s;
  o[1] = (tmp11 + tmp1) >> s;
  o[3] = (tmp11 - tmp1) >> s;
  o[2] = tmp12 >> s;
}

// One 10-point pass of jpeg_idct_10x10 (8 inputs); pass 1 shifts (but
// outputs 2 and 7, already at pass-1 scale), pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct10_1d(const int* z, int* o) {
  int z3 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                  : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int z4 = z[4];
  int z1 = z4 * FIX(1.144122806);
  int z2 = z4 * FIX(0.437016024);
  int tmp10 = z3 + z1, tmp11 = z3 - z2;
  int tmp22 = z3 - (z1 - z2) * 2;
  if (!SECOND) tmp22 >>= CONST_BITS - PASS1_BITS;
  z2 = z[2];
  z3 = z[6];
  z1 = (z2 + z3) * FIX(0.831253876);
  int tmp12 = z1 + z2 * FIX(0.513743148);
  int tmp13 = z1 - z3 * FIX(2.176250899);
  int tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
  int tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;

  z1 = z[1];
  z2 = z[3];
  z3 = z[5];
  z4 = z[7];
  tmp11 = z2 + z4;
  tmp13 = z2 - z4;
  tmp12 = tmp13 * FIX(0.309016994);
  int z5 = z3 * (1 << CONST_BITS);
  z2 = tmp11 * FIX(0.951056516);
  z4 = z5 + tmp12;
  tmp10 = z1 * FIX(1.396802247) + z2 + z4;
  int tmp14 = z1 * FIX(0.221231742) - z2 + z4;
  z2 = tmp11 * FIX(0.587785252);
  z4 = z5 - tmp12 - tmp13 * (1 << (CONST_BITS - 1));
  tmp12 = SECOND ? (z1 - tmp13) * (1 << CONST_BITS) - z5 : (z1 - tmp13 - z3) * (1 << PASS1_BITS);
  tmp11 = z1 * FIX(1.260073511) - z2 - z4;
  tmp13 = z1 * FIX(0.642039522) - z2 + z4;
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp20 + tmp10) >> s;
  o[9] = (tmp20 - tmp10) >> s;
  o[1] = (tmp21 + tmp11) >> s;
  o[8] = (tmp21 - tmp11) >> s;
  o[2] = tmp22 + tmp12;
  o[7] = tmp22 - tmp12;
  o[3] = (tmp23 + tmp13) >> s;
  o[6] = (tmp23 - tmp13) >> s;
  o[4] = (tmp24 + tmp14) >> s;
  o[5] = (tmp24 - tmp14) >> s;
}

__device__ void idct8(const int16_t* in, const int* q, uint8_t* out, long long stride) {
  int ws[64];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int z[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) z[r] = int(in[r * 8 + c]) * q[r * 8 + c];
    islow_1d(z, o);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = descale(o[r], CONST_BITS - PASS1_BITS);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int o[8];
    islow_1d(ws + r * 8, o);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      out[r * stride + c] = uint8_t(range_limit(descale(o[c], CONST_BITS + PASS1_BITS + 3)));
  }
}

__device__ void idct5(const int16_t* in, const int* q, uint8_t* out, long long stride) {
  int ws[25];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    int z[5], o[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) z[r] = int(in[r * 5 + c]) * q[r * 8 + c];
    idct5_1d<false>(z, o);
#pragma unroll
    for (int r = 0; r < 5; ++r) ws[r * 5 + c] = o[r];
  }
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    int o[5];
    idct5_1d<true>(ws + r * 5, o);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      out[r * stride + c] = uint8_t(range_limit(o[c] >> (CONST_BITS + PASS1_BITS + 3)));
  }
}

__device__ void idct10(const int16_t* in, const int* q, uint8_t* out, long long stride) {
  int ws[80];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int z[8], o[10];
#pragma unroll
    for (int r = 0; r < 8; ++r) z[r] = int(in[r * 8 + c]) * q[r * 8 + c];
    idct10_1d<false>(z, o);
#pragma unroll
    for (int r = 0; r < 10; ++r) ws[r * 8 + c] = o[r];
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    int o[10];
    idct10_1d<true>(ws + r * 8, o);
#pragma unroll
    for (int c = 0; c < 10; ++c)
      out[r * stride + c] = uint8_t(range_limit(o[c] >> (CONST_BITS + PASS1_BITS + 3)));
  }
}

// grid: (blocks of the largest component / blockDim, components); one
// thread per 8x8 coefficient block.
__global__ void jpeg_idct_kernel(const int16_t* __restrict__ coef, const int* __restrict__ qt,
                                 const int* __restrict__ comps, uint8_t* __restrict__ planes) {
  const int* d = comps + COMP_INTS * blockIdx.y;
  const int bw = d[2], bh = d[3];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (long long)bw * bh) return;
  const int k = d[4], s = d[5];
  const long long pw = d[7];
  const int16_t* in = coef + d[0] + b * k * k;
  int q[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) q[i] = qt[d[6] + i];
  const long long bx = b % bw, by = b / bw;
  uint8_t* out = planes + d[1] + by * s * pw + bx * s;
  if (s == 8) idct8(in, q, out, pw);
  else if (s == 5) idct5(in, q, out, pw);
  else idct10(in, q, out, pw);
}

__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes, const int* cd, const int* u,
                                      int x, int y) {
  const uint8_t* p = planes + cd[1];
  const long long pw = cd[7];
  const int dw = u[3], dh = u[4];
  switch (u[0]) {
    case UP_H2V1: {
      const uint8_t* row = p + y * pw;
      int i = x >> 1, t = 3 * row[i];
      return (x & 1) ? (t + row[min(i + 1, dw - 1)] + 2) >> 2 : (t + row[max(i - 1, 0)] + 1) >> 2;
    }
    case UP_H1V2: {
      int j = y >> 1, jn = (y & 1) ? min(j + 1, dh - 1) : max(j - 1, 0);
      return (3 * p[j * pw + x] + p[jn * pw + x] + ((y & 1) ? 2 : 1)) >> 2;
    }
    case UP_H2V2: {
      int j = y >> 1, jn = (y & 1) ? min(j + 1, dh - 1) : max(j - 1, 0);
      int i = x >> 1, i2 = (x & 1) ? min(i + 1, dw - 1) : max(i - 1, 0);
      int cs = 3 * p[j * pw + i] + p[jn * pw + i];
      int cs2 = 3 * p[j * pw + i2] + p[jn * pw + i2];
      return (3 * cs + cs2 + ((x & 1) ? 7 : 8)) >> 4;
    }
    case UP_BOX:
      return p[(y / u[2]) * pw + x / u[1]];
    default:
      return p[y * pw + x];
  }
}

// One thread per output pixel of the (B, TH, TW, 3) batch.
__global__ void jpeg_color_kernel(const uint8_t* __restrict__ planes, const int* __restrict__ comps,
                                  const int* __restrict__ images, const int* __restrict__ tiles,
                                  int n_slots, int th, int tw, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_slots * th * tw) return;
  const int x = int(i % tw);
  const long long t = i / tw;
  const int y = int(t % th);
  const int slot = int(t / th);
  const int* td = tiles + TILE_INTS * slot;
  if (td[0] == 2) return;
  uint8_t* o = out + i * 3;
  const int* im = images + IMAGE_INTS * td[1];
  const int X = td[2] + x, Y = td[3] + y;
  if (td[0] == 0 || X >= im[2] || Y >= im[3]) {
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const int* cd = comps + COMP_INTS * im[1];
  int yv = sample(planes, cd, im + 5, X, Y);
  if (im[4] == 0) {
    o[0] = o[1] = o[2] = uint8_t(yv);
    return;
  }
  int cb = sample(planes, cd + COMP_INTS, im + 10, X, Y) - 128;
  int cr = sample(planes, cd + 2 * COMP_INTS, im + 15, X, Y) - 128;
  // jdcolor.c: FIX(1.40200), FIX(0.34414), FIX(0.71414), FIX(1.77200) at 16 bits
  int r = yv + ((91881 * cr + 32768) >> 16);
  int g = yv + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
  int b = yv + ((116130 * cb + 32768) >> 16);
  o[0] = uint8_t(min(max(r, 0), 255));
  o[1] = uint8_t(min(max(g, 0), 255));
  o[2] = uint8_t(min(max(b, 0), 255));
}

}  // namespace

extern "C" {

// Launch the IDCT over n_comps components whose largest has max_blocks
// blocks. Returns cudaGetLastError() after the launch.
int aq_jpeg_idct(const void* coef, const void* qt, const void* comps, int n_comps, int max_blocks,
                 void* planes, void* stream) {
  if (n_comps <= 0 || max_blocks <= 0) return 0;
  dim3 grid((max_blocks + 127) / 128, n_comps);
  jpeg_idct_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int*)qt, (const int*)comps, (uint8_t*)planes);
  return (int)cudaGetLastError();
}

int aq_jpeg_color(const void* planes, const void* comps, const void* images, const void* tiles,
                  int n_slots, int th, int tw, void* out, void* stream) {
  long long n = (long long)n_slots * th * tw;
  if (n <= 0) return 0;
  jpeg_color_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int*)comps, (const int*)images, (const int*)tiles, n_slots, th, tw,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
