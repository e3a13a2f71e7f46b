// JPEG reconstruction on the card: dequantisation + integer IDCT, chroma
// upsampling, YCbCr->RGB, the crop and the hard tile grid, fused into one
// hand-written kernel for sm_90a with a plain C interface (bound with ctypes
// by data/jpeg_cuda.py).
//
// Not a port of a TPU kernel: the JAX package decodes JPEG on host threads
// with libjpeg-turbo (its tileloader.cc, decode_jpeg). Here the host
// keeps the serial part, the Huffman entropy decode (csrc/jpeg_entropy.cc),
// and this kernel does the parallel part, writing the uint8 tiles straight
// into the device batch that the serving program reads. The arithmetic is
// libjpeg-turbo's, exactly: the IDCT jddctmgr.c picks for each component's
// scaled size (jpeg_idct_islow for 8x8; jidctred.c's 1x1, 2x2 and 4x4;
// jidctint.c's 3x3, 5x5, 6x6, 7x7 and the 10x10, 12x12 and 14x14 that
// 4:2:0 chroma takes at 5/8, 6/8 and 7/8), libjpeg's range-limit table,
// jdsample.c's fancy upsampling and its box upsampling by 1 to 4 (the
// integral factors of sampling factors 1..4), jdcolor.c's fixed-point
// YCbCr tables, its grey replication and its RGB copy. All of
// it is integer, so any split across threads gives the same bytes. The
// plain version is data/jpeg_plain.py's decode_batch_plain; chip_smoke.py
// holds the kernel against it with torch.equal.
//
// Bound. Bytes: the int16 coefficients read once and the tiles written
// once (no plane goes through device memory), 2 x 1,572,864 + 3,145,728
// bytes a 1024 px 4:2:0 tile at 8/8, 0.241 ms per batch of 128 at
// 3.35 TB/s: the larger term (at N/8 the kept squares, what each IDCT
// reads, set the bytes: 0.019, 0.070, 0.051, 0.132, 0.119, 0.153, 0.194 ms
// from 1/8 to 7/8). Operations: libjpeg's own integer
// arithmetic (the IDCTs with their dequantisation and range limit per
// block, the fancy upsampler's taps and jdcolor's per pixel), counted by
// chip_smoke.py's jpeg_ops from each batch's data, at the most the SMs
// issue (128 integer lanes an SM, at most two of those operations an
// instruction): about 0.09 ms at 8/8. The kernel issues many more
// instructions than that ideal, shared-memory ones above all (the SM
// serves about one warp-wide shared access per cycle), so it is built to
// run few instructions per byte and to keep every intermediate on chip:
//
// - Grid (stripes, slots, bands). A CTA owns a column stripe of STRIPE_W
//   output pixels of one slot over a band of its rows and walks down the
//   image in steps of whole MCU rows (up to STEP_ROWS output rows, so
//   that each step's work amortises its two barriers). Caller slots exit;
//   zero slots, and rows and columns past the image, are written as zeros.
// - Per step, each component's new block rows under the stripe are
//   inverse-transformed by 8 threads a block (one column each, a warp
//   barrier, one row each) through a padded shared workspace of 8 rows
//   (pitch 9: no bank conflicts); a 10x10, 12x12 or 14x14 block holds its
//   column's rows past 8 in registers and runs them in a second round
//   through the same rows. The quantisation tables are loaded once
//   per CTA. A thread reads its block row as one 16-byte load where it is
//   aligned. Static shared memory stays under the 48 KB a kernel may
//   declare.
//   The descale's rounding is folded into the butterfly's even part and
//   the range limit is four instructions; divisions are multiply-highs.
// - The samples go into a ring of block rows per component in shared
//   memory: a component upsampled vertically keeps the block rows above
//   and below too (jdmainct.c's context rows), so each block is
//   transformed once per stripe and band; a one-block horizontal halo at
//   the stripe's sides is the only recomputation (1.25x of the chroma at
//   4:2:0). The upsampler's clamps are at the downsampled size (dw-1,
//   dh-1), not the padded block grid's. Each ring starts at a pad that
//   puts the stripe's runs on 16-byte boundaries.
// - The colour pass takes 16 pixels a thread: luma and full-width chroma
//   as one 16-byte shared load a row, 2x chroma as 4 + 8 + 4 bytes a row,
//   with bytes pulled out by shifts (byte loads cost a shared access
//   each); it writes the run's 48 bytes as three 16-byte stores. Runs at
//   the image's right edge or off the 16-byte grid (e.g. a whole-image
//   decode 333 px wide) go pixel by pixel, out of line.
//
// Descriptors, all int32 (data/jpeg_plain.py builds them):
//   comps  (8 per component of each image): coef_off, plane_off, blocks_w,
//          blocks_h, K, S, qt_off, plane_w (plane_* serve the plain version)
//   images (20 per image): ncomp, comp_base, out_w, out_h, color (0 grey,
//          1 YCbCr, 2 RGB), then per component: mode, h factor, v factor,
//          downsampled w, downsampled h
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
constexpr int TILE_DECODED = 1;
constexpr int TILE_CALLER = 2;

// The geometry; data/jpeg_plain.py holds the same values (checked at load).
constexpr int STRIPE_W = 128;    // output pixels across one CTA
constexpr int STEP_ROWS = 64;    // output rows per step: the MCU rows that fit
constexpr int RING_ROWS = 64;    // sample rows of one component's ring
constexpr int RING_PITCH = 176;  // bytes per ring row, a multiple of 16 (44 words: the 8 rows of
                                 // a block's stores fall on distinct banks): the widest stripe's
                                 // blocks (11 of 14x14 chroma at 7/8, 154 bytes) and its pad to
                                 // the 16-byte grid (up to 15), and RING_SLACK past a 2x
                                 // upsampler's
constexpr int RING_SLACK = 8;    // bytes a 2x horizontal upsampler's word reads may pass its
                                 // last sample (the others read no byte past it)
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / 8;  // one IDCT block per 8 threads
constexpr int WS_PITCH = 9;          // ints per workspace row: conflict-free columns
constexpr int WS_ROWS = 8;           // workspace rows: pass 1's rows past 8 wait in registers for
                                     // pass 2's second round
constexpr int WS_STRIDE = 72;        // ints per group's workspace (8 rows of 9)
static_assert(WS_ROWS * WS_PITCH <= WS_STRIDE, "pass 1 writes WS_ROWS rows at a time");
constexpr int RUN = 16;              // output pixels per colour-pass item

enum { UP_FULL = 0, UP_H2V1, UP_H1V2, UP_H2V2, UP_BOX };
enum { COLOR_GREY = 0, COLOR_YCC, COLOR_RGB };

#define FIX(x) ((int)((x) * (1 << CONST_BITS) + 0.5))

// libjpeg's post-IDCT range limit of x >> SHIFT (the last pass's shift):
// the low 10 bits read as signed, plus 128, clamped to 0..255. Bits
// SHIFT..SHIFT+9 of x, sign-extended, are (x << (22 - SHIFT)) >> 22.
template <int SHIFT>
__device__ __forceinline__ int range_limit_at(int x) {
  return min(max(((x << (22 - SHIFT)) >> 22) + 128, 0), 255);
}

// One 8-point pass of jpeg_idct_islow, with its descale's rounding term
// added: every output takes exactly one of tmp0 and tmp1, so adding
// `round` to both adds it to each output, as DESCALE does.
__device__ __forceinline__ void islow_1d(const int* z, int* o, int round) {
  int z2 = z[2], z3 = z[6];
  int z1 = (z2 + z3) * 4433;
  int tmp2 = z1 + z3 * -15137;
  int tmp3 = z1 + z2 * 6270;
  int tmp0 = (z[0] + z[4]) * (1 << CONST_BITS) + round;
  int tmp1 = (z[0] - z[4]) * (1 << CONST_BITS) + round;
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

// The coefficient index of place i of an S x S IDCT's kept square (the
// rows and columns it reads: jidctred.c's 2x2 reads 0, 1, 3, 5, 7 and its
// 4x4 0-3 and 5-7), as data/jpeg_plain.py's kept_index.
template <int S>
__device__ __forceinline__ constexpr int kept_index(int i) {
  return S == 2 ? (i == 0 ? 0 : 2 * i - 1) : S == 4 && i >= 4 ? i + 1 : i;
}

// Row r of a block's K x K kept coefficients, dequantised by the natural-
// order table's row q, into the workspace.
template <int S, int K>
__device__ __forceinline__ void load_row(const int16_t* __restrict__ in, const int* q, int* ws) {
  int16_t v[K];
  if (K == 8 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const int4 w = *reinterpret_cast<const int4*>(in);
    const int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = int16_t(u[i] & 0xFFFF);
      v[2 * i + 1] = int16_t(u[i] >> 16);
    }
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = in[c];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) ws[c] = int(v[c]) * q[kept_index<S>(c)];
}

// One 3-point pass of jpeg_idct_3x3; pass 1 shifts, pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct3_1d(const int* z, int* o) {
  int tmp0 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                    : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int tmp12 = z[2] * FIX(0.707106781);
  const int tmp10 = tmp0 + tmp12, tmp2 = tmp0 - tmp12 - tmp12;
  tmp0 = z[1] * FIX(1.224744871);
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp10 + tmp0) >> s;
  o[2] = (tmp10 - tmp0) >> s;
  o[1] = tmp2 >> s;
}

// One 6-point pass of jpeg_idct_6x6; pass 1 shifts (but outputs 1 and 4,
// already at pass-1 scale), pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct6_1d(const int* z, int* o) {
  int tmp0 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                    : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int tmp10 = z[4] * FIX(0.707106781);
  int tmp1 = tmp0 + tmp10;
  int tmp11 = tmp0 - tmp10 - tmp10;
  if (!SECOND) tmp11 >>= CONST_BITS - PASS1_BITS;
  tmp0 = z[2] * FIX(1.224744871);
  tmp10 = tmp1 + tmp0;
  const int tmp12 = tmp1 - tmp0;
  const int z1 = z[1], z2 = z[3], z3 = z[5];
  tmp1 = (z1 + z3) * FIX(0.366025404);
  tmp0 = tmp1 + (z1 + z2) * (1 << CONST_BITS);
  const int tmp2 = tmp1 + (z3 - z2) * (1 << CONST_BITS);
  tmp1 = (z1 - z2 - z3) * (1 << (SECOND ? CONST_BITS : PASS1_BITS));
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp10 + tmp0) >> s;
  o[5] = (tmp10 - tmp0) >> s;
  o[1] = tmp11 + tmp1;
  o[4] = tmp11 - tmp1;
  o[2] = (tmp12 + tmp2) >> s;
  o[3] = (tmp12 - tmp2) >> s;
}

// One 7-point pass of jpeg_idct_7x7; pass 1 shifts, pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct7_1d(const int* z, int* o) {
  int tmp13 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                     : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int z1 = z[2], z2 = z[4], z3 = z[6];
  int tmp10 = (z2 - z3) * FIX(0.881747734);
  int tmp12 = (z1 - z2) * FIX(0.314692123);
  const int tmp11 = tmp10 + tmp12 + tmp13 - z2 * FIX(1.841218003);
  int tmp0 = z1 + z3;
  z2 -= tmp0;
  tmp0 = tmp0 * FIX(1.274162392) + tmp13;
  tmp10 += tmp0 - z3 * FIX(0.077722536);
  tmp12 += tmp0 - z1 * FIX(2.470602249);
  tmp13 += z2 * FIX(1.414213562);
  z1 = z[1];
  z2 = z[3];
  z3 = z[5];
  int tmp1 = (z1 + z2) * FIX(0.935414347);
  int tmp2 = (z1 - z2) * FIX(0.170262339);
  tmp0 = tmp1 - tmp2;
  tmp1 += tmp2;
  tmp2 = (z2 + z3) * -FIX(1.378756276);
  tmp1 += tmp2;
  z2 = (z1 + z3) * FIX(0.613604268);
  tmp0 += z2;
  tmp2 += z2 + z3 * FIX(1.870828693);
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp10 + tmp0) >> s;
  o[6] = (tmp10 - tmp0) >> s;
  o[1] = (tmp11 + tmp1) >> s;
  o[5] = (tmp11 - tmp1) >> s;
  o[2] = (tmp12 + tmp2) >> s;
  o[4] = (tmp12 - tmp2) >> s;
  o[3] = tmp13 >> s;
}

// One 12-point pass of jpeg_idct_12x12 (8 inputs); pass 1 shifts, pass 2
// does not.
template <bool SECOND>
__device__ __forceinline__ void idct12_1d(const int* z, int* o) {
  int z3 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                  : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int z4 = z[4] * FIX(1.224744871);
  int tmp10 = z3 + z4, tmp11 = z3 - z4;
  int z1 = z[2];
  z4 = z1 * FIX(1.366025404);
  z1 *= 1 << CONST_BITS;
  int z2 = z[6] * (1 << CONST_BITS);
  int tmp12 = z1 - z2;
  const int tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
  tmp12 = z4 + z2;
  const int tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
  tmp12 = z4 - z1 - z2;
  const int tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;

  z1 = z[1];
  z2 = z[3];
  z3 = z[5];
  z4 = z[7];
  tmp11 = z2 * FIX(1.306562965);
  int tmp14 = z2 * -4433;  // -FIX(0.541196100)
  tmp10 = z1 + z3;
  int tmp15 = (tmp10 + z4) * FIX(0.860918669);
  tmp12 = tmp15 + tmp10 * FIX(0.261052384);
  tmp10 = tmp12 + tmp11 + z1 * FIX(0.280143716);
  int tmp13 = (z3 + z4) * -FIX(1.045510580);
  tmp12 += tmp13 + tmp14 - z3 * FIX(1.478575242);
  tmp13 += tmp15 - tmp11 + z4 * FIX(1.586706681);
  tmp15 += tmp14 - z1 * FIX(0.676326758) - z4 * FIX(1.982889723);
  z1 -= z4;
  z2 -= z3;
  z3 = (z1 + z2) * 4433;   // FIX(0.541196100)
  tmp11 = z3 + z1 * 6270;  // FIX(0.765366865)
  tmp14 = z3 - z2 * 15137; // FIX(1.847759065)
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp20 + tmp10) >> s;
  o[11] = (tmp20 - tmp10) >> s;
  o[1] = (tmp21 + tmp11) >> s;
  o[10] = (tmp21 - tmp11) >> s;
  o[2] = (tmp22 + tmp12) >> s;
  o[9] = (tmp22 - tmp12) >> s;
  o[3] = (tmp23 + tmp13) >> s;
  o[8] = (tmp23 - tmp13) >> s;
  o[4] = (tmp24 + tmp14) >> s;
  o[7] = (tmp24 - tmp14) >> s;
  o[5] = (tmp25 + tmp15) >> s;
  o[6] = (tmp25 - tmp15) >> s;
}

// One 14-point pass of jpeg_idct_14x14 (8 inputs); pass 1 shifts (but
// outputs 3 and 10, already at pass-1 scale), pass 2 does not.
template <bool SECOND>
__device__ __forceinline__ void idct14_1d(const int* z, int* o) {
  int z1 = SECOND ? (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
                  : z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1));
  int z4 = z[4];
  int z2 = z4 * FIX(1.274162392);
  int z3 = z4 * FIX(0.314692123);
  z4 *= FIX(0.881747734);
  int tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
  int tmp23 = z1 - (z2 + z3 - z4) * 2;
  if (!SECOND) tmp23 >>= CONST_BITS - PASS1_BITS;
  z1 = z[2];
  z2 = z[6];
  z3 = (z1 + z2) * FIX(1.105676686);
  int tmp13 = z3 + z1 * FIX(0.273079590);
  int tmp14 = z3 - z2 * FIX(1.719280954);
  int tmp15 = z1 * FIX(0.613604268) - z2 * FIX(1.378756276);
  const int tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
  const int tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
  const int tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;

  z1 = z[1];
  z2 = z[3];
  z3 = z[5];
  const int w4 = z[7] * (1 << CONST_BITS);
  tmp14 = z1 + z3;
  tmp11 = (z1 + z2) * FIX(1.334852607);
  tmp12 = tmp14 * FIX(1.197448846);
  tmp10 = tmp11 + tmp12 + w4 - z1 * FIX(1.126980169);
  tmp14 *= FIX(0.752406978);
  int tmp16 = tmp14 - z1 * FIX(1.061150426);
  z1 -= z2;
  tmp15 = z1 * FIX(0.467085129) - w4;
  tmp16 += tmp15;
  int t = (z2 + z3) * -FIX(0.158341681) - w4;
  tmp11 += t - z2 * FIX(0.424103948);
  tmp12 += t - z3 * FIX(2.373959773);
  t = (z3 - z2) * FIX(1.405321284);
  tmp14 += t + w4 - z3 * FIX(1.6906431334);
  tmp15 += t + z2 * FIX(0.674957567);
  const int sh = SECOND ? CONST_BITS : PASS1_BITS;
  tmp13 = (z1 - z3) * (1 << sh) + z[7] * (1 << sh);
  const int s = SECOND ? 0 : CONST_BITS - PASS1_BITS;
  o[0] = (tmp20 + tmp10) >> s;
  o[13] = (tmp20 - tmp10) >> s;
  o[1] = (tmp21 + tmp11) >> s;
  o[12] = (tmp21 - tmp11) >> s;
  o[2] = (tmp22 + tmp12) >> s;
  o[11] = (tmp22 - tmp12) >> s;
  o[3] = tmp23 + tmp13;
  o[10] = tmp23 - tmp13;
  o[4] = (tmp24 + tmp14) >> s;
  o[9] = (tmp24 - tmp14) >> s;
  o[5] = (tmp25 + tmp15) >> s;
  o[8] = (tmp25 - tmp15) >> s;
  o[6] = (tmp26 + tmp16) >> s;
  o[7] = (tmp26 - tmp16) >> s;
}

// One pass of jidctred.c's jpeg_idct_2x2 on its kept indices 0, 1, 3, 5, 7
// (z[0..4]), its descale's rounding added (pass 1 also shifts).
template <bool SECOND>
__device__ __forceinline__ void red2_1d(const int* z, int* o) {
  const int tmp10 = z[0] * (1 << (CONST_BITS + 2));
  const int tmp0 = z[4] * -FIX(0.720959822) + z[3] * FIX(0.850430095) + z[2] * -FIX(1.272758580) +
                   z[1] * FIX(3.624509785);
  const int n = SECOND ? CONST_BITS + PASS1_BITS + 3 + 2 : CONST_BITS - PASS1_BITS + 2;
  const int round = 1 << (n - 1), s = SECOND ? 0 : n;
  o[0] = (tmp10 + tmp0 + round) >> s;
  o[1] = (tmp10 - tmp0 + round) >> s;
}

// One pass of jidctred.c's jpeg_idct_4x4 on its kept indices 0-3, 5-7
// (z[0..6]), its descale's rounding added (pass 1 also shifts).
template <bool SECOND>
__device__ __forceinline__ void red4_1d(const int* z, int* o) {
  const int n = SECOND ? CONST_BITS + PASS1_BITS + 3 + 1 : CONST_BITS - PASS1_BITS + 1;
  const int round = 1 << (n - 1), s = SECOND ? 0 : n;
  int tmp0 = z[0] * (1 << (CONST_BITS + 1)) + round;
  int tmp2 = z[2] * 15137 + z[5] * -6270;  // FIX(1.847759065), -FIX(0.765366865)
  const int tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
  const int z1 = z[6], z2 = z[4], z3 = z[3], z4 = z[1];
  tmp0 = z1 * -FIX(0.211164243) + z2 * FIX(1.451774981) + z3 * -FIX(2.172734803) + z4 * FIX(1.061594337);
  tmp2 = z1 * -FIX(0.509795579) + z2 * -FIX(0.601344887) + z3 * 7373 + z4 * 20995;  // FIX(0.899976223),
                                                                                        // FIX(2.562915447)
  o[0] = (tmp10 + tmp2) >> s;
  o[3] = (tmp10 - tmp2) >> s;
  o[1] = (tmp12 + tmp0) >> s;
  o[2] = (tmp12 - tmp0) >> s;
}

// Each IDCT size's passes: K coefficients a side in (the square the entropy
// decoder keeps), S samples out, and the range limit's shift after pass 2.
template <int S>
struct Idct;
template <>
struct Idct<2> {
  static constexpr int K = 5, SHIFT = CONST_BITS + PASS1_BITS + 3 + 2;
  template <bool B> __device__ static void pass(const int* z, int* o) { red2_1d<B>(z, o); }
};
template <>
struct Idct<3> {
  static constexpr int K = 3, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct3_1d<B>(z, o); }
};
template <>
struct Idct<4> {
  static constexpr int K = 7, SHIFT = CONST_BITS + PASS1_BITS + 3 + 1;
  template <bool B> __device__ static void pass(const int* z, int* o) { red4_1d<B>(z, o); }
};
template <>
struct Idct<5> {
  static constexpr int K = 5, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct5_1d<B>(z, o); }
};
template <>
struct Idct<6> {
  static constexpr int K = 6, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct6_1d<B>(z, o); }
};
template <>
struct Idct<7> {
  static constexpr int K = 7, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct7_1d<B>(z, o); }
};
template <>
struct Idct<8> {
  static constexpr int K = 8, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) {
    islow_1d(z, o, 1 << (B ? CONST_BITS + PASS1_BITS + 2 : CONST_BITS - PASS1_BITS - 1));
    if (!B) {
#pragma unroll
      for (int r = 0; r < 8; ++r) o[r] >>= CONST_BITS - PASS1_BITS;
    }
  }
};
template <>
struct Idct<10> {
  static constexpr int K = 8, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct10_1d<B>(z, o); }
};
template <>
struct Idct<12> {
  static constexpr int K = 8, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct12_1d<B>(z, o); }
};
template <>
struct Idct<14> {
  static constexpr int K = 8, SHIFT = CONST_BITS + PASS1_BITS + 3;
  template <bool B> __device__ static void pass(const int* z, int* o) { idct14_1d<B>(z, o); }
};

// Pass 2 of one row of an S x S block: workspace row ws_row (K ints) to
// S samples at dst, 8 or 4 at once where aligned.
template <int S>
__device__ __forceinline__ void idct_row(const int* ws_row, uint8_t* row) {
  constexpr int K = Idct<S>::K;
  int z[K], o[S];
#pragma unroll
  for (int c = 0; c < K; ++c) z[c] = ws_row[c];
  Idct<S>::template pass<true>(z, o);
  if constexpr (S == 8 || S == 4) {
    uint32_t w[S / 4] = {};
#pragma unroll
    for (int c = 0; c < S; ++c) w[c >> 2] |= uint32_t(range_limit_at<Idct<S>::SHIFT>(o[c])) << (8 * (c & 3));
    if ((reinterpret_cast<uintptr_t>(row) & (S - 1)) == 0) {
      if constexpr (S == 8) *reinterpret_cast<uint2*>(row) = make_uint2(w[0], w[1]);
      else *reinterpret_cast<uint32_t*>(row) = w[0];
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c) row[c] = uint8_t(range_limit_at<Idct<S>::SHIFT>(o[c]));
}

// The IDCT of one S x S block by its 8 threads (lane t of 0..7, mask the
// group's lanes): lane t < K loads and dequantises row t of the block's
// K x K coefficients, runs pass 1 over column t, then pass 2 over rows t
// and t + 8 < S, writing its samples to dst at a pitch of RING_PITCH.
// Past WS_ROWS rows (10x10, 12x12, 14x14) pass 1's rows 8.. stay in
// registers until the first 8 rows are out, then take the workspace's rows
// 0.. for a second round (lane t: row t + 8). jpeg_idct_1x1 is the DC alone. A
// lane's pass 2 reads only rows that no other lane's next load writes, so
// the group's next block needs no barrier before its load.
template <int S>
__device__ void idct_group(const int16_t* __restrict__ in, const int* q, int* ws, uint8_t* dst, int t,
                           unsigned mask) {
  if constexpr (S == 1) {
    if (t == 0) dst[0] = uint8_t(range_limit_at<3>(int(in[0]) * q[0] + 4));
  } else {
    constexpr int K = Idct<S>::K, R = S < WS_ROWS ? S : WS_ROWS;  // R: the rows of a round
    if (t < K) load_row<S, K>(in + t * K, q + kept_index<S>(t) * 8, ws + t * WS_PITCH);
    __syncwarp(mask);
    int o[S];
    if (t < K) {
      int z[K];
#pragma unroll
      for (int r = 0; r < K; ++r) z[r] = ws[r * WS_PITCH + t];
      Idct<S>::template pass<false>(z, o);
#pragma unroll
      for (int r = 0; r < R; ++r) ws[r * WS_PITCH + t] = o[r];
    }
    __syncwarp(mask);
    for (int r = t; r < R; r += 8) idct_row<S>(ws + r * WS_PITCH, dst + r * RING_PITCH);
    if constexpr (S > WS_ROWS) {
      __syncwarp(mask);  // every lane has read its rows of the first round
#pragma unroll
      for (int r = WS_ROWS; r < S; ++r) ws[(r - WS_ROWS) * WS_PITCH + t] = o[r];
      __syncwarp(mask);
      if (t < S - WS_ROWS) idct_row<S>(ws + t * WS_PITCH, dst + (t + WS_ROWS) * RING_PITCH);
    }
  }
}

// One component as a CTA sees it: where its blocks are, how it upsamples,
// the blocks under the stripe and band, and its ring.
struct __align__(16) Comp {
  const int16_t* coef;
  int bw, k, s, mode, hf, vf, dw, dh;
  int vc;          // block rows per step
  int fv;          // 1 if the upsampler reads the rows above and below
  int ns;          // ring slots: vc block rows, plus the context rows
  int br0, br1, bc0, bc1;  // block rows and columns under the stripe and band
  int c0;          // the sample column at the ring's byte 0: bc0 * s less a pad
                   // that puts the stripe's first run on a 16-byte boundary
  int qt_off;
  unsigned row_magic, col_magic;  // ceil(2^32 / (ns * s)), ceil(2^32 / (bc1 - bc0))
};

// Samples [a, b) of one axis that output pixels [lo, hi) read
// (jpeg_plain._span).
__host__ __device__ __forceinline__ void span(bool fancy, int factor, int n, int lo, int hi, int& a, int& b) {
  if (fancy) {
    a = max((lo >> 1) - 1, 0);
    b = min(((hi - 1) >> 1) + 1, n - 1) + 1;
  } else {
    a = lo / factor;
    b = (hi - 1) / factor + 1;
  }
}

// The tile's pixels inside the image under a CTA's columns [x_lo, x_hi)
// and rows [y_lo, y_hi): columns [x_lo, xe), rows [y_lo, ye); none
// (ye == y_lo) for a zero slot or a stripe past the image.
__host__ __device__ __forceinline__ void inside(const int* td, const int* im, int x_lo, int x_hi, int y_lo, int y_hi,
                                                int& xe, int& ye) {
  xe = x_lo;
  ye = y_lo;
  if (td[0] == TILE_DECODED) {
    xe = max(x_lo, min(x_hi, im[2] - td[2]));
    ye = max(y_lo, min(y_hi, im[3] - td[3]));
  }
  if (xe == x_lo) ye = y_lo;
}

// One component's upsampling and the blocks under image pixels [Xa, Xb) x
// [Ya, Yb), with its ring's c0 (jpeg_plain.stripe_blocks): cd its
// descriptor, u its five ints of the image's.
__host__ __device__ __forceinline__ void comp_blocks(const int* cd, const int* u, int Xa, int Xb, int Ya, int Yb,
                                                     Comp& g) {
  g.s = cd[5];
  g.mode = u[0];
  g.hf = u[1];
  g.vf = u[2];
  g.dw = u[3];
  g.dh = u[4];
  const bool fh = g.mode == UP_H2V1 || g.mode == UP_H2V2;
  g.fv = g.mode == UP_H1V2 || g.mode == UP_H2V2;
  int a, b;
  span(fh, g.hf, g.dw, Xa, Xb, a, b);
  g.bc0 = a / g.s;
  g.bc1 = (b - 1) / g.s + 1;
  span(g.fv, g.vf, g.dh, Ya, Yb, a, b);
  g.br0 = a / g.s;
  g.br1 = (b - 1) / g.s + 1;
  // the sample column under the stripe's first pixel, on the 16-byte grid
  const int first = fh ? Xa >> 1 : Xa / g.hf;
  g.c0 = g.bc0 * g.s - ((g.bc0 * g.s - first) & 15);
}

// x / d for 0 <= x < 2^22 and 1 <= d <= 64 as a multiply-high by magic =
// ceil(2^32 / d), exact in that range (magic_of(1) wraps to 0: d = 1 is
// passed through).
__device__ __forceinline__ unsigned magic_of(int d) { return 0xFFFFFFFFu / unsigned(d) + 1; }

__device__ __forceinline__ int div_magic(int x, int d, unsigned magic) {
  return d == 1 ? x : int(__umulhi(unsigned(x), magic));
}

__device__ __forceinline__ int mod_magic(int x, int d, unsigned magic) { return x - div_magic(x, d, magic) * d; }

// A component's ring in registers, for the colour pass: sample row r lives
// in ring row r mod (ns * s) (block row r / s in slot (r / s) mod ns), and
// sample column i at byte i - c0 of its row.
struct Ring {
  const uint8_t* base;  // the ring less c0: base[i] is sample column i of row 0
  unsigned magic;
  int rows, dw, dh;

  __device__ __forceinline__ const uint8_t* row(int r) const {
    return base + mod_magic(r, rows, magic) * RING_PITCH;
  }
};

__device__ __forceinline__ Ring ring_of(const Comp& g, const uint8_t* ring) {
  Ring v;
  v.base = ring - g.c0;
  v.rows = g.ns * g.s;
  v.magic = g.row_magic;
  v.dw = g.dw;
  v.dh = g.dh;
  return v;
}

// One component's sample under output pixel (X, Y), any mode: near the
// ring row under the pixel's row, far its vertical neighbour.
__device__ __forceinline__ int sample(const Comp& c, const Ring& g, int X, int Y) {
  const uint8_t* near;
  const uint8_t* far = nullptr;
  if (c.fv) {
    const int jr = Y >> 1, jn = (Y & 1) ? min(jr + 1, g.dh - 1) : max(jr - 1, 0);
    near = g.row(jr);
    far = g.row(jn);
  } else {
    near = g.row(Y / c.vf);
  }
  switch (c.mode) {
    case UP_H2V1: {
      int i = X >> 1, t = 3 * near[i];
      return (X & 1) ? (t + near[min(i + 1, g.dw - 1)] + 2) >> 2 : (t + near[max(i - 1, 0)] + 1) >> 2;
    }
    case UP_H1V2:
      return (3 * near[X] + far[X] + ((Y & 1) ? 2 : 1)) >> 2;
    case UP_H2V2: {
      int i = X >> 1, i2 = (X & 1) ? min(i + 1, g.dw - 1) : max(i - 1, 0);
      int cs = 3 * near[i] + far[i];
      int cs2 = 3 * near[i2] + far[i2];
      return (3 * cs + cs2 + ((X & 1) ? 7 : 8)) >> 4;
    }
    case UP_BOX:
      return near[X / c.hf];
    default:
      return near[X];
  }
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int i) { return (w[i >> 2] >> (8 * (i & 3))) & 255; }

// 16 bytes of a ring row at a 16-byte boundary: one shared load.
__device__ __forceinline__ void load16(const uint8_t* p, uint32_t* w) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// The source columns i0-1 .. i0+8 of a 2x horizontal upsampler's run from
// one ring row (i0 on an 8-byte boundary): the word before, 8 bytes, the
// word after, with jdsample.c's edge replication at columns 0 and dw-1.
struct Cols10 {
  int prev, next;
  uint32_t mid[2];

  __device__ __forceinline__ Cols10(const uint8_t* row, int i0, int dw) {
    const uint2 m = *reinterpret_cast<const uint2*>(row + i0);
    mid[0] = m.x;
    mid[1] = m.y;
    prev = i0 > 0 ? int(*reinterpret_cast<const uint32_t*>(row + i0 - 4) >> 24) : int(m.x & 255);
    next = i0 + 8 < dw ? int(*reinterpret_cast<const uint32_t*>(row + i0 + 8) & 255) : int(m.y >> 24);
  }
  // column i0 + k, k in -1 .. 8
  __device__ __forceinline__ int at(int k) const { return k < 0 ? prev : k > 7 ? next : byte_of(mid, k); }
};

// The chroma of a run of RUN pixels from X (even) on row Y in mode MODE,
// jdsample.c's loops: a 2x upsampler reads each source column (or its
// column sum 3 * near + far) once and slides a window of three along the
// run: pixels 2m and 2m + 1 take columns m - 1, m, m + 1 of it.
template <int MODE>
__device__ __forceinline__ void chroma_run(const Ring& g, int X, int Y, int* v) {
  if (MODE == UP_FULL || MODE == UP_H1V2) {
    uint32_t a[4];
    if (MODE == UP_FULL) {
      load16(g.row(Y) + X, a);
#pragma unroll
      for (int p = 0; p < RUN; ++p) v[p] = byte_of(a, p);
    } else {
      const int jr = Y >> 1, jn = (Y & 1) ? min(jr + 1, g.dh - 1) : max(jr - 1, 0);
      const int bias = (Y & 1) ? 2 : 1;
      uint32_t b[4];
      load16(g.row(jr) + X, a);
      load16(g.row(jn) + X, b);
#pragma unroll
      for (int p = 0; p < RUN; ++p) v[p] = (3 * byte_of(a, p) + byte_of(b, p) + bias) >> 2;
    }
  } else {
    const int i0 = X >> 1;
    int cs[RUN / 2 + 2];
    if (MODE == UP_H2V1) {
      const Cols10 n(g.row(Y), i0, g.dw);
#pragma unroll
      for (int k = 0; k < RUN / 2 + 2; ++k) cs[k] = n.at(k - 1);
#pragma unroll
      for (int m = 0; m < RUN / 2; ++m) {
        const int t = 3 * cs[m + 1];
        v[2 * m] = (t + cs[m] + 1) >> 2;
        v[2 * m + 1] = (t + cs[m + 2] + 2) >> 2;
      }
    } else {
      const int jr = Y >> 1, jn = (Y & 1) ? min(jr + 1, g.dh - 1) : max(jr - 1, 0);
      const Cols10 n(g.row(jr), i0, g.dw), f(g.row(jn), i0, g.dw);
#pragma unroll
      for (int k = 0; k < RUN / 2 + 2; ++k) cs[k] = 3 * n.at(k - 1) + f.at(k - 1);
#pragma unroll
      for (int m = 0; m < RUN / 2; ++m) {
        const int t = 3 * cs[m + 1];
        v[2 * m] = (t + cs[m] + 8) >> 4;
        v[2 * m + 1] = (t + cs[m + 2] + 7) >> 4;
      }
    }
  }
}

// jdcolor.c's ycc_rgb_convert, FIX(1.40200), FIX(0.34414), FIX(0.71414),
// FIX(1.77200) at 16 bits.
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int& r, int& g, int& b) {
  cb -= 128;
  cr -= 128;
  r = min(max(y + ((91881 * cr + 32768) >> 16), 0), 255);
  g = min(max(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16), 0), 255);
  b = min(max(y + ((116130 * cb + 32768) >> 16), 0), 255);
}

// Byte k of a run's 3 * RUN output bytes, packed into w.
__device__ __forceinline__ void put_byte(uint32_t* w, int k, int v) { w[k >> 2] |= uint32_t(v) << (8 * (k & 3)); }

// A run's pixels one by one, any layout, bytes straight to p: pixels
// [0, n_in) inside the image, [n_in, n) zero. The colour pass's slow path
// (the image's right edge, odd origins, rows off the 16-byte grid, layouts
// without a run path); kept out of line so that it is compiled once.
__device__ __noinline__ void pixels_one_by_one(const Comp* comp, const uint8_t* rings, int ncomp, int color, int X,
                                               int Y, int n_in, int n, uint8_t* p) {
  const Ring g0 = ring_of(comp[0], rings);
  for (int i = 0; i < n; ++i) {
    int r = 0, g = 0, b = 0;
    if (i < n_in) {
      r = g = b = sample(comp[0], g0, X + i, Y);
      if (ncomp == 3) {
        const int c1 = sample(comp[1], ring_of(comp[1], rings + RING_ROWS * RING_PITCH), X + i, Y);
        const int c2 = sample(comp[2], ring_of(comp[2], rings + 2 * RING_ROWS * RING_PITCH), X + i, Y);
        if (color == COLOR_RGB) {  // jdcolor.c's rgb_rgb_convert: the components as they are
          g = c1;
          b = c2;
        } else {
          ycc_rgb(r, c1, c2, r, g, b);
        }
      }
    }
    p[3 * i] = uint8_t(r);
    p[3 * i + 1] = uint8_t(g);
    p[3 * i + 2] = uint8_t(b);
  }
}

// The colour pass over output rows [r0, r1) of the image, RUN pixels a
// thread: LAYOUT -1 for grey, else the chroma's mode under full-size YCbCr
// luma (-2: any other layout or colour, pixel by pixel). A run that is whole, inside the
// image, on an even column, on the rings' 16-byte grid (each ring's c0
// puts the stripe's runs there) and on the output's takes the run path and
// three 16-byte stores; others go pixel by pixel.
template <int LAYOUT>
__device__ __forceinline__ void colour_pass(const Comp* comp, const uint8_t* rings, const Ring& g0, const Ring& g1,
                                            const Ring& g2, int ncomp, int color, int r0, int r1, int runs,
                                            unsigned runs_magic, int x_lo, int x_hi, int xe, int tx, int ty, int tw,
                                            uint8_t* o) {
  for (int i = threadIdx.x; i < (r1 - r0) * runs; i += THREADS) {
    const int q = div_magic(i, runs, runs_magic);
    const int Y = r0 + q, x = x_lo + (i - q * runs) * RUN;
    const int n = min(RUN, x_hi - x), n_in = max(min(RUN, xe - x), 0);
    const int X = tx + x;
    uint8_t* const p = o + ((long long)(Y - ty) * tw + x) * 3;
    if (LAYOUT != -2 && n_in == RUN && (X & 1) == 0 && ((reinterpret_cast<uintptr_t>(g0.base) + X) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      uint32_t y[4], w[3 * RUN / 4] = {};
      load16(g0.row(Y) + X, y);
      if (LAYOUT == -1) {
#pragma unroll
        for (int k = 0; k < 3 * RUN; ++k) put_byte(w, k, byte_of(y, k / 3));
      } else {
        constexpr int CM = LAYOUT < 0 ? UP_FULL : LAYOUT;
        int cb[RUN], cr[RUN];
        chroma_run<CM>(g1, X, Y, cb);
        chroma_run<CM>(g2, X, Y, cr);
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
          int r, g, b;
          ycc_rgb(byte_of(y, k), cb[k], cr[k], r, g, b);
          put_byte(w, 3 * k, r);
          put_byte(w, 3 * k + 1, g);
          put_byte(w, 3 * k + 2, b);
        }
      }
      uint4* q4 = reinterpret_cast<uint4*>(p);
      q4[0] = make_uint4(w[0], w[1], w[2], w[3]);
      q4[1] = make_uint4(w[4], w[5], w[6], w[7]);
      q4[2] = make_uint4(w[8], w[9], w[10], w[11]);
    } else {
      pixels_one_by_one(comp, rings, ncomp, color, X, Y, n_in, n, p);
    }
  }
}

// Zeros over n <= RUN pixels at p: three 16-byte stores where aligned.
__device__ __forceinline__ void zero_run(uint8_t* p, int n) {
  if (n == RUN && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
    q[0] = q[1] = q[2] = make_uint4(0, 0, 0, 0);
    return;
  }
  for (int b = 0; b < 3 * n; ++b) p[b] = 0;
}

// grid: (stripes, slots, bands); THREADS threads. One instantiation per
// scale N/8 holds only that scale's IDCTs: N x N, 2N x 2N for a chroma
// that needs no upsampling, and below 4/8 4N x 4N for one sampled 4 x 4
// below the luma (a kernel that carried all eleven sizes ran 8-10% slower
// at 8/8 and 5/8 for its code alone).
template <int N>
__global__ void __launch_bounds__(THREADS, 4)
jpeg_decode_kernel(const int16_t* __restrict__ coef, const int* __restrict__ qt, const int* __restrict__ comps,
                   const int* __restrict__ images, const int* __restrict__ tiles, int th, int tw, int band_rows,
                   uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t ring[3][RING_ROWS * RING_PITCH];
  __shared__ __align__(16) int ws_all[GROUPS * WS_STRIDE];
  __shared__ __align__(16) int qs[3][64];
  __shared__ Comp comp[3];
  __shared__ int step_h;

  const int slot = blockIdx.y, tid = threadIdx.x;
  const int* td = tiles + TILE_INTS * slot;
  const int kind = td[0];
  if (kind == TILE_CALLER) return;
  const int x_lo = blockIdx.x * STRIPE_W, x_hi = min(x_lo + STRIPE_W, tw);
  const int y_lo = blockIdx.z * band_rows, y_hi = min(y_lo + band_rows, th);
  const int runs = (x_hi - x_lo + RUN - 1) / RUN;
  const unsigned runs_magic = magic_of(runs);
  uint8_t* const o = out + (long long)slot * th * tw * 3;
  const int* im = images + IMAGE_INTS * td[1];
  int xe, ye;
  inside(td, im, x_lo, x_hi, y_lo, y_hi, xe, ye);
  const int tx = td[2], ty = td[3];
  // rows past the image (all of them for a zero slot or a stripe past it)
  for (int i = tid; i < (y_hi - ye) * runs; i += THREADS) {
    const int q = div_magic(i, runs, runs_magic);
    const int x = x_lo + (i - q * runs) * RUN;
    zero_run(o + ((long long)(ye + q) * tw + x) * 3, min(RUN, x_hi - x));
  }
  if (ye == y_lo) return;

  const int ncomp = im[0], color = im[4];
  const int Xa = tx + x_lo, Xb = tx + xe, Ya = ty + y_lo, Yb = ty + ye;
  if (tid == 0) {
    int mh = 0;
    for (int c = 0; c < ncomp; ++c) {
      const int* cd = comps + COMP_INTS * (im[1] + c);
      const int* u = im + 5 + 5 * c;
      Comp g;
      g.coef = coef + cd[0];
      g.bw = cd[2];
      g.k = cd[4];
      g.qt_off = cd[6];
      comp_blocks(cd, u, Xa, Xb, Ya, Yb, g);
      mh = max(mh, g.s * g.vf);
      comp[c] = g;
    }
    const int k = max(STEP_ROWS / mh, 1);  // MCU rows per step
    for (int c = 0; c < ncomp; ++c) {
      Comp& g = comp[c];
      g.vc = k * (mh / (g.s * g.vf));
      g.ns = g.vc + 2 * g.fv;
      g.row_magic = magic_of(g.ns * g.s);
      g.col_magic = magic_of(g.bc1 - g.bc0);
      // describe_batch refuses a geometry outside the ring (_check_ring)
      const int slack = g.mode == UP_H2V1 || g.mode == UP_H2V2 ? RING_SLACK : 0;
      if (g.ns * g.s > RING_ROWS || g.bc1 * g.s - g.c0 > RING_PITCH - slack || mh % (g.s * g.vf)) __trap();
    }
    step_h = k * mh;
  }
  __syncthreads();
  for (int i = tid; i < 64 * ncomp; i += THREADS) qs[i >> 6][i & 63] = qt[comp[i >> 6].qt_off + (i & 63)];
  const int step = step_h;  // output rows per step
  const Ring g0 = ring_of(comp[0], ring[0]);
  Ring g1 = g0, g2 = g0;
  if (ncomp == 3) {
    g1 = ring_of(comp[1], ring[1]);
    g2 = ring_of(comp[2], ring[2]);
  }
  // the colour pass's layout: grey, or full-size YCbCr luma with both
  // chromas in one mode; anything else (RGB-coded files too) pixel by pixel
  int layout = -2;
  if (ncomp == 1 && comp[0].mode == UP_FULL) layout = -1;
  if (ncomp == 3 && color == COLOR_YCC && comp[0].mode == UP_FULL && comp[1].mode == comp[2].mode &&
      comp[1].mode != UP_BOX)
    layout = comp[1].mode;
  const int lane8 = tid & 7, group = tid >> 3;
  const unsigned gmask = 0xFFu << (tid & 24);
  int* const ws = ws_all + group * WS_STRIDE;
  int next[3] = {0, 0, 0};  // per component: the first block row not yet in the ring

  for (int m = Ya / step; m * step < Yb; ++m) {
    // the block rows this step adds to each ring
    int first[3], jobs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      first[c] = jobs[c] = 0;
      if (c < ncomp) {
        const Comp& g = comp[c];
        const int lo = max(m * g.vc - g.fv, g.br0), hi = min((m + 1) * g.vc + g.fv, g.br1);
        first[c] = max(next[c], lo);
        jobs[c] = max(hi - first[c], 0) * (g.bc1 - g.bc0);
#ifdef AQ_AB_COLOUR_ONLY  // scripts/jpeg_decode_ab.py --cuts: no IDCT runs
        jobs[c] = 0;
#endif
        next[c] = max(next[c], hi);
      }
    }
    __syncthreads();  // the ring's slots and (first step) the tables
    // the step's blocks, component after component, dealt to the groups
    // in turn: group g takes every job j (counted over all components)
    // with j mod GROUPS == g
    int before = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < ncomp && jobs[c] > 0) {
        const Comp& g = comp[c];
        const int nb = g.bc1 - g.bc0, s_ = g.s, kk = g.k * g.k, bw = g.bw, rows = g.ns * s_;
        const unsigned col_magic = g.col_magic, row_magic = g.row_magic;
        const int16_t* base = g.coef + ((long long)first[c] * bw + g.bc0) * kk;
        uint8_t* const ring_c = ring[c] + g.bc0 * s_ - g.c0;
        for (int jj = (group - before) & (GROUPS - 1); jj < jobs[c]; jj += GROUPS) {
          const int row = div_magic(jj, nb, col_magic), col = jj - row * nb;
          const int16_t* in = base + (row * bw + col) * kk;
          uint8_t* dst = ring_c + mod_magic((first[c] + row) * s_, rows, row_magic) * RING_PITCH + col * s_;
          if (s_ == N) {
            idct_group<N>(in, qs[c], ws, dst, lane8, gmask);
          } else if (N < 8 && s_ == 2 * N) {
            idct_group<(N < 8 ? 2 * N : N)>(in, qs[c], ws, dst, lane8, gmask);
          } else if (N < 4 && s_ == 4 * N) {  // a component sampled 4 x 4 below another's
            idct_group<(N < 4 ? 4 * N : N)>(in, qs[c], ws, dst, lane8, gmask);
          } else {
            __trap();  // describe_batch gives a batch one scale
          }
        }
      }
      if (c < ncomp) before += jobs[c];
    }
    __syncthreads();
    // colour: this step's output rows inside [Ya, Yb)
    const int r0 = max(m * step, Ya), r1 = min((m + 1) * step, Yb);
#define AQ_COLOUR(L) \
  colour_pass<L>(comp, ring[0], g0, g1, g2, ncomp, color, r0, r1, runs, runs_magic, x_lo, x_hi, xe, tx, ty, tw, o)
#ifndef AQ_AB_IDCT_ONLY  // scripts/jpeg_decode_ab.py --cuts: no colour pass runs
    switch (layout) {
      case -1: AQ_COLOUR(-1); break;
      case UP_FULL: AQ_COLOUR(UP_FULL); break;
      case UP_H2V1: AQ_COLOUR(UP_H2V1); break;
      case UP_H1V2: AQ_COLOUR(UP_H1V2); break;
      case UP_H2V2: AQ_COLOUR(UP_H2V2); break;
      default: AQ_COLOUR(-2); break;
    }
#endif
#undef AQ_COLOUR
  }
}

using KernelFn = void (*)(const int16_t*, const int*, const int*, const int*, const int*, int, int, int, uint8_t*);

// The kernel of scale N/8, for N of 1..8; nullptr for another N.
KernelFn kernel_for(int n) {
  switch (n) {
    case 1: return jpeg_decode_kernel<1>;
    case 2: return jpeg_decode_kernel<2>;
    case 3: return jpeg_decode_kernel<3>;
    case 4: return jpeg_decode_kernel<4>;
    case 5: return jpeg_decode_kernel<5>;
    case 6: return jpeg_decode_kernel<6>;
    case 7: return jpeg_decode_kernel<7>;
    case 8: return jpeg_decode_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// The blocks that the CTA for (slot, stripe) over rows [y_lo, y_hi) of
// its tile reads, by the kernel's own arithmetic: 4 ints per component
// (first block row, end, first block column, end) into out; returns the
// number of components, 0 when it reads none. jpeg_plain.stripe_blocks
// computes the same; the CPU tests hold the two equal.
extern "C" int aq_jpeg_stripe_blocks(const int* comps, const int* images, const int* tiles, int slot, int tw,
                                     int stripe, int y_lo, int y_hi, int* out) {
  const int* td = tiles + TILE_INTS * slot;
  if (td[0] != TILE_DECODED) return 0;
  const int* im = images + IMAGE_INTS * td[1];
  const int x_lo = stripe * STRIPE_W, x_hi = min(x_lo + STRIPE_W, tw);
  int xe, ye;
  inside(td, im, x_lo, x_hi, y_lo, y_hi, xe, ye);
  if (ye == y_lo) return 0;
  for (int c = 0; c < im[0]; ++c) {
    Comp g;
    comp_blocks(comps + COMP_INTS * (im[1] + c), im + 5 + 5 * c, td[2] + x_lo, td[2] + xe, td[3] + y_lo,
                td[3] + ye, g);
    const int v[4] = {g.br0, g.br1, g.bc0, g.bc1};
    for (int i = 0; i < 4; ++i) out[4 * c + i] = v[i];
  }
  return im[0];
}

extern "C" {

// Decode a batch of images at scale_n/8 into out (n_slots, th, tw, 3)
// uint8: grid (stripes, n_slots, bands of band_rows). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a scale
// outside 1..8).
int aq_jpeg_decode(const void* coef, const void* qt, const void* comps, const void* images, const void* tiles,
                   int n_slots, int th, int tw, int band_rows, int scale_n, void* out, void* stream) {
  const KernelFn kernel = kernel_for(scale_n);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_slots <= 0 || th <= 0 || tw <= 0) return 0;
  dim3 grid((tw + STRIPE_W - 1) / STRIPE_W, n_slots, (th + band_rows - 1) / band_rows);
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int*)qt, (const int*)comps, (const int*)images, (const int*)tiles, th, tw,
      band_rows, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The geometry the kernel was built with: STRIPE_W, RING_ROWS, RING_PITCH,
// RING_SLACK.
void aq_jpeg_geometry(int* out) {
  out[0] = STRIPE_W;
  out[1] = RING_ROWS;
  out[2] = RING_PITCH;
  out[3] = RING_SLACK;
}

// The scale_n/8 kernel's registers per thread, static shared memory and
// local (spill) bytes per thread, threads per CTA, and resident CTAs per
// SM. Returns the CUDA error of the queries.
int aq_jpeg_attributes(int scale_n, int* out) {
  const KernelFn kernel = kernel_for(scale_n);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = THREADS;
  out[4] = ctas;
  return (int)err;
}

}  // extern "C"
