// Host half of the port's JPEG decoder: marker parsing and entropy decode,
// on a thread pool, into de-zigzagged, still-quantised int16 coefficients.
//
// Counterpart of the JPEG half of the JAX package's tileloader.cc, split another
// way: the serial part (the entropy decode) stays on host threads here, and
// the parallel part (dequantisation, IDCT, chroma upsampling, colour
// conversion and the tile grid) runs in csrc/jpeg_decode.cu on the card, or
// in data/jpeg_plain.py on the CPU. No libjpeg: the bitstream is parsed here.
//
// Takes every JPEG that libjpeg-turbo 2.1.5 decodes to RGB: 8-bit frames of
// 1 component (grey) or 3 (YCbCr, or RGB by jdapimin.c's colour-space
// guess), sampling factors 1..4 in integral ratios, restart intervals
// throughout, Huffman (jdhuff.c, jdphuff.c; for sequential files the
// standard tables where the file defines none, as jstdhuff.c installs
// them) or arithmetic coding
// (jdarith.c, with the DAC marker's conditioning):
// - sequential (SOF0/SOF1/SOF9) in one interleaved scan, straight into each
//   block's kept coefficients;
// - progressive (SOF2/SOF10: DC first, DC refinement, AC first, AC
//   refinement) and sequential in several scans (a first scan without every
//   component), into whole 8x8 blocks scan by scan (libjpeg's pre-zeroed
//   coefficient buffer: a non-interleaved scan covers only its component's
//   own blocks, and the MCU-padding blocks keep what interleaved scans gave
//   them); a progressive file whose scans leave AC coefficients 1..9 short
//   of their last bits is then smoothed as jdcoefct.c's
//   decompress_smooth_data smooths it; each block is then cut to its kept
//   coefficients.
// Data that ends early (a marker or the file's end inside a scan) is read as
// libjpeg reads it: the Huffman decoders finish the MCU on zero bits and
// leave the rest of the restart interval as it was, the arithmetic decoder
// reads zeros on. A JPEG that libjpeg refuses (precision other than 8,
// another component count, lossless or hierarchical processes, sampling
// factors past 4 or in a fractional ratio, more than 10 blocks in an MCU)
// is KIND_REFUSED, with the frame's size; markers that do not parse as
// libjpeg parses them, and anything that is neither JPEG nor TIFF,
// KIND_UNREADABLE. The caller skips both, as the JAX package's loader skips
// a file its libjpeg refuses. TIFF (classic or BigTIFF) is KIND_TIFF, read
// by csrc/tiff_decode.cc (built into the same library); decode_jpeg_segment
// takes its JPEG strips and tiles, each with the file's JPEGTables.
//
// At scale N/8 every coefficient is still parsed, but each block keeps only
// the K x K square that its scaled IDCT reads (kept_index): the DC for the
// 1x1, the top-left N x N for jidctint.c's N x N (N = 3, 5, 6, 7), indices
// 0, 1, 3, 5, 7 of each axis for jidctred.c's 2x2 and 0-3, 5-7 for its
// 4x4, and all 8 x 8 for the 8x8 and larger ones. The scaled IDCT size of
// each component follows libjpeg-turbo's jpeg_calc_output_dimensions:
// chroma of 4:2:0 at N/8 takes a 2N x 2N IDCT (up to 14x14 at 7/8), so that
// it needs no upsampling.
//
// C ABI (bound with ctypes by data/native_loader.py): aq_jpeg_probe,
// aq_jpeg_decode for one file, and a loader (aq_jpeg_loader_create / peek /
// segments / pop / pop_pixels / meta / destroy) whose worker threads decode
// files ahead of the caller (JPEGs to coefficients, TIFFs to pixels or JPEG
// segments), at most `depth` files and 1 GiB of decoded bytes past the
// oldest one not yet popped, and hand them out in path order.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "tiff_decode.h"

using namespace aq;

namespace {

constexpr int kLook = 10;
constexpr int kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION
constexpr int kArithTables = 16;      // NUM_ARITH_TBLS

// natural (row-major) index of the k-th zigzag coefficient; 16 extra
// entries catch a corrupt run past the end, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool present = false;
  bool bad = false;  // defined, but libjpeg's jpeg_make_d_derived_tbl refuses it
  uint8_t huffval[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLook];   // (length << 8) | symbol; 0 = longer code
  int32_t fast_ac[1 << kLook]; // value * 256 | run << 4 | bits used; 0 = none
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
};

// One scan's header: its components (indices into the frame's), spectral
// band Ss..Se and successive-approximation bits Ah, Al.
struct Scan {
  int ncomp = 0;
  int comp[4] = {0, 0, 0, 0};
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Header {
  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1, precision = 8;
  int restart_interval = 0, sof = 0;
  bool saw_sof = false, saw_sos = false;
  bool progressive = false, arith = false;
  bool multi_scan = false;  // progressive, or sequential with a first scan short of a component
  bool rgb = false;         // three components coded as RGB (jdapimin.c's guess)
  Comp comp[4];
  uint16_t qt[4][64];  // natural order, as last defined
  bool qt_present[4] = {false, false, false, false};
  // each component's table, latched at its first scan (jdinput.c's
  // latch_quant_tables); zeros for a component no scan holds
  uint16_t latched[4][64] = {};
  bool is_latched[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  // the arithmetic conditioning of each table (DAC; SOI's defaults)
  uint8_t dc_l[kArithTables], dc_u[kArithTables], ac_k[kArithTables];
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  Scan scan;              // the scan whose header was read last
  size_t scan_start = 0;  // where its entropy-coded data starts

  Header() {
    std::fill(dc_l, dc_l + kArithTables, 0);
    std::fill(dc_u, dc_u + kArithTables, 1);
    std::fill(ac_k, ac_k + kArithTables, 5);
  }
};

inline int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }

// A Huffman table from its DHT counts and values. A table whose codes
// overflow their lengths, or a DC table with a symbol past 15, is marked
// bad: libjpeg refuses it when a scan first uses it, not when it is defined.
void build_huff(const uint8_t* counts, const uint8_t* vals, int nvals, bool is_ac, Huff* h) {
  h->present = true;
  h->bad = true;
  int huffsize[257];
  int huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1 << si)) return;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0xFFFFF;
  if (!is_ac)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) return;  // a DC category past 15
  std::memcpy(h->huffval, vals, nvals);
  std::memset(h->look, 0, sizeof(h->look));
  std::memset(h->fast_ac, 0, sizeof(h->fast_ac));
  p = 0;
  for (int l = 1; l <= kLook; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int lookbits = huffcode[p] << (kLook - l);
      for (int ctr = 1 << (kLook - l); ctr > 0; --ctr) h->look[lookbits++] = uint16_t((l << 8) | vals[p]);
    }
  }
  if (is_ac) {
    for (int peek = 0; peek < (1 << kLook); ++peek) {
      int e = h->look[peek];
      if (!e) continue;
      int l = e >> 8, rs = e & 0xFF, r = rs >> 4, s = rs & 15;
      if (s == 0 || l + s > kLook) continue;
      int extra = (peek >> (kLook - l - s)) & ((1 << s) - 1);
      h->fast_ac[peek] = extend(extra, s) * 256 + (r << 4) + (l + s);
    }
  }
  h->bad = false;
}

// The tables of T.81 K.3 (jstdhuff.c): counts per code length, then values.
const uint8_t kStdDcLuma[16 + 12] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
                                     0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdDcChroma[16 + 12] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                       0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[16 + 162] = {
    0,    2,    1,    3,    3,    2,    4,    3,    5,    5,    4,    4,    0,    0,    1,    0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
const uint8_t kStdAcChroma[16 + 162] = {
    0,    2,    1,    2,    4,    4,    3,    4,    7,    5,    4,    4,    0,    1,    2,    0x77,
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

void std_huff(const uint8_t* t, int nvals, bool is_ac, Huff* h) {
  if (!h->present) build_huff(t, t + 16, nvals, is_ac, h);
}

inline int seg_len(const uint8_t* d, size_t n, size_t pos) {
  if (pos + 2 > n) return -1;
  return (d[pos] << 8) | d[pos + 1];
}

// An SOS segment's header into h->scan (and each of its components' table
// selectors). Returns a Kind.
int parse_sos(const uint8_t* s, int slen, Header* h) {
  if (slen < 1) return KIND_UNREADABLE;
  Scan& sc = h->scan;
  int ns = s[0];
  if (ns < 1 || ns > 4 || slen != 1 + 2 * ns + 3) return KIND_UNREADABLE;
  sc.ncomp = ns;
  for (int i = 0; i < ns; ++i) {
    int cid = s[1 + 2 * i], tables = s[2 + 2 * i];
    int ci = -1;
    for (int c = h->ncomp - 1; c >= 0; --c)
      if (h->comp[c].id == cid) ci = c;
    if (ci < 0) return KIND_UNREADABLE;
    for (int j = 0; j < i; ++j)
      if (sc.comp[j] == ci) return KIND_UNREADABLE;
    sc.comp[i] = ci;
    h->comp[ci].td = tables >> 4;
    h->comp[ci].ta = tables & 15;
  }
  sc.ss = s[1 + 2 * ns];
  sc.se = s[2 + 2 * ns];
  sc.ah = s[3 + 2 * ns] >> 4;
  sc.al = s[3 + 2 * ns] & 15;
  return KIND_BASELINE;
}

// An SOF0/1/2/9/10 segment: the frame, and whether libjpeg-turbo decodes it
// to RGB (jdinput.c's initial_setup, jdsample.c's integral ratios,
// jdcolor.c's conversions). Returns a Kind.
int parse_sof(int m, const uint8_t* s, int slen, Header* h) {
  if (h->saw_sof || slen < 6) return KIND_UNREADABLE;
  h->saw_sof = true;
  h->sof = m;
  h->progressive = m == 0xC2 || m == 0xCA;
  h->arith = m == 0xC9 || m == 0xCA;
  h->precision = s[0];
  h->height = (s[1] << 8) | s[2];
  h->width = (s[3] << 8) | s[4];
  h->ncomp = s[5];
  if (h->width <= 0 || h->height <= 0 || h->ncomp <= 0) return KIND_REFUSED;  // JERR_EMPTY_IMAGE (DNL)
  if (slen != 6 + 3 * h->ncomp) return KIND_UNREADABLE;
  if (h->precision != 8 || h->width > kMaxDimension || h->height > kMaxDimension) return KIND_REFUSED;
  if (h->ncomp != 1 && h->ncomp != 3) return KIND_REFUSED;  // CMYK, YCCK, 2 or 4+: no RGB conversion
  h->max_h = h->max_v = 1;
  for (int c = 0; c < h->ncomp; ++c) {
    Comp& cp = h->comp[c];
    cp.id = s[6 + 3 * c];
    cp.h = s[7 + 3 * c] >> 4;
    cp.v = s[7 + 3 * c] & 15;
    cp.tq = s[8 + 3 * c];
    if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4) return KIND_REFUSED;  // JERR_BAD_SAMPLING
    h->max_h = std::max(h->max_h, cp.h);
    h->max_v = std::max(h->max_v, cp.v);
  }
  for (int c = 0; c < h->ncomp; ++c)
    if (h->max_h % h->comp[c].h || h->max_v % h->comp[c].v) return KIND_REFUSED;  // JERR_FRACT_SAMPLE_NOTIMPL
  return KIND_BASELINE;
}

// Parse markers from *at (2 for the first call: past SOI) up to the next
// SOS, whose header goes into h->scan, with *at and h->scan_start at its
// entropy-coded data (skipped by the search for the next marker, which
// passes stuffed bytes and RSTn): returns KIND_BASELINE, or KIND_END at EOI
// or the end of the data after a scan, or the Kind that ends the file's
// route (a process libjpeg refuses, markers it does not parse: jdmarker.c's
// read_markers).
int read_markers(const uint8_t* d, size_t n, size_t* at, Header* h) {
  const int end = h->saw_sos ? KIND_END : KIND_UNREADABLE;
  size_t pos = *at;
  while (true) {
    // find the next marker: 0xFF, fill bytes, code
    const void* ff = pos < n ? std::memchr(d + pos, 0xFF, n - pos) : nullptr;
    if (ff == nullptr) return end;
    pos = size_t(static_cast<const uint8_t*>(ff) - d);
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return end;
    int m = d[pos++];
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // stuffed byte, TEM, RSTn
    if (m == 0xD9) return end;                                           // EOI
    const bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC;  // APPn, COM, DNL
    int len = seg_len(d, n, pos);
    if (len < 0) return skipped ? end : KIND_UNREADABLE;  // a length cut short reads the fake EOI
    if (len < 2) {
      if (!skipped) return KIND_UNREADABLE;
      pos += 2;  // libjpeg skips a negative remainder as nothing
      continue;
    }
    const uint8_t* s = d + pos + 2;
    int slen = len - 2;
    std::vector<uint8_t> padded;
    if (pos + size_t(len) > n) {
      // past the end of the data, libjpeg's memory source feeds a fake EOI
      // (FF D9) again and again: a segment reads those bytes, a skipped
      // one ends there
      if (skipped) return end;
      padded.resize(size_t(slen));
      const size_t have = n > pos + 2 ? n - pos - 2 : 0;
      for (size_t i = 0; i < padded.size(); ++i) padded[i] = i < have ? s[i] : ((i - have) % 2 ? 0xD9 : 0xFF);
      s = padded.data();
    }
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC9: case 0xCA: {
        int kind = parse_sof(m, s, slen, h);
        if (kind != KIND_BASELINE) return kind;
        break;
      }
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        // lossless, hierarchical, JPG: JERR_SOF_UNSUPPORTED (the frame's size for the caller)
        if (h->saw_sof) return KIND_UNREADABLE;
        h->sof = m;
        if (slen >= 5) {
          h->precision = s[0];
          h->height = (s[1] << 8) | s[2];
          h->width = (s[3] << 8) | s[4];
        }
        return KIND_REFUSED;
      case 0xC4: {  // DHT
        int q = 0;
        while (slen - q > 16) {
          int tc = s[q] >> 4, th = s[q] & 15;
          int nv = 0;
          for (int i = 0; i < 16; ++i) nv += s[q + 1 + i];
          if (nv > 256 || q + 17 + nv > slen || tc > 1 || th > 3) return KIND_UNREADABLE;
          build_huff(s + q + 1, s + q + 17, nv, tc == 1, tc ? &h->ac[th] : &h->dc[th]);
          q += 17 + nv;
        }
        if (q != slen) return KIND_UNREADABLE;
        break;
      }
      case 0xDB: {  // DQT: any nonzero precision nibble reads 16-bit values
        int q = 0;
        while (q < slen) {
          int pq = s[q] >> 4, tq = s[q] & 15;
          if (tq > 3) return KIND_UNREADABLE;
          int need = pq ? 129 : 65;
          if (q + need > slen) return KIND_UNREADABLE;
          for (int k = 0; k < 64; ++k)
            h->qt[tq][kNatural[k]] =
                pq ? uint16_t((s[q + 1 + 2 * k] << 8) | s[q + 2 + 2 * k]) : s[q + 1 + k];
          h->qt_present[tq] = true;
          q += need;
        }
        break;
      }
      case 0xCC: {  // DAC: arithmetic conditioning per table
        if (slen % 2) return KIND_UNREADABLE;
        for (int q = 0; q < slen; q += 2) {
          int index = s[q], val = s[q + 1];
          if (index >= 2 * kArithTables) return KIND_UNREADABLE;
          if (index >= kArithTables) {
            h->ac_k[index - kArithTables] = uint8_t(val);
          } else {
            h->dc_l[index] = uint8_t(val & 15);
            h->dc_u[index] = uint8_t(val >> 4);
            if (h->dc_l[index] > h->dc_u[index]) return KIND_UNREADABLE;
          }
        }
        break;
      }
      case 0xDD:  // DRI
        if (slen != 2) return KIND_UNREADABLE;
        h->restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xE0:  // jdmarker.c's examine_app0 reads 14 bytes
        if (slen >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) h->jfif = true;
        break;
      case 0xEE:
        if (slen >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
          h->adobe = true;
          h->adobe_transform = s[11];
        }
        break;
      case 0xDA: {  // SOS
        if (!h->saw_sof) return KIND_UNREADABLE;
        int kind = parse_sos(s, slen, h);
        if (kind != KIND_BASELINE) return kind;
        h->saw_sos = true;
        *at = h->scan_start = std::min(pos + len, n);
        return KIND_BASELINE;
      }
      default:
        if (!skipped) return KIND_UNREADABLE;  // SOI again, DHP, EXP, JPGn, RESn: JERR_UNKNOWN_MARKER
        break;
    }
    pos += len;
  }
}

// The scan in h->scan against the frame's process (jdinput.c's
// per_scan_setup, jdhuff.c's, jdphuff.c's and jdarith.c's start_pass
// checks), its tables present; latches the quantisation table of each
// component at its first scan. Returns a Kind.
int check_scan(Header* h) {
  const Scan& sc = h->scan;
  int blocks = 0;
  for (int i = 0; i < sc.ncomp; ++i) {
    const int c = sc.comp[i];
    const Comp& cp = h->comp[c];
    blocks += cp.h * cp.v;
    if (!h->is_latched[c]) {
      if (cp.tq > 3 || !h->qt_present[cp.tq]) return KIND_UNREADABLE;
      std::memcpy(h->latched[c], h->qt[cp.tq], sizeof(h->latched[c]));
      h->is_latched[c] = true;
    }
  }
  if (sc.ncomp > 1 && blocks > 10) return KIND_UNREADABLE;  // libjpeg's D_MAX_BLOCKS_IN_MCU
  bool need_dc = true, need_ac = true;
  if (h->progressive) {
    bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ncomp != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13 || bad) return KIND_UNREADABLE;  // libjpeg: JERR_BAD_PROGRESSION
    need_dc = sc.ss == 0 && sc.ah == 0;
    need_ac = sc.ss > 0;
  }
  // (a sequential scan's Ss, Se, Ah, Al are only warned about; libjpeg
  // decodes the whole block)
  if (h->arith) return KIND_BASELINE;  // every arithmetic table index (0..15) has its statistics
  for (int i = 0; i < sc.ncomp; ++i) {
    const Comp& cp = h->comp[sc.comp[i]];
    if (need_dc && (cp.td > 3 || !h->dc[cp.td].present || h->dc[cp.td].bad)) return KIND_UNREADABLE;
    if (need_ac && (cp.ta > 3 || !h->ac[cp.ta].present || h->ac[cp.ta].bad)) return KIND_UNREADABLE;
  }
  return KIND_BASELINE;
}

// Parse markers up to the first SOS and check it. Returns a Kind.
int parse_header(const uint8_t* d, size_t n, Header* h) {
  if (n >= 4 && ((d[0] == 'I' && d[1] == 'I' && (d[2] == 42 || d[2] == 43) && d[3] == 0) ||
                 (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && (d[3] == 42 || d[3] == 43))))
    return KIND_TIFF;  // classic or BigTIFF
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return KIND_UNREADABLE;
  size_t pos = 2;
  int kind = read_markers(d, n, &pos, h);
  if (kind != KIND_BASELINE) return kind;
  if (h->ncomp == 3) {
    // libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
    if (h->jfif) h->rgb = false;
    else if (h->adobe) h->rgb = h->adobe_transform == 0;
    else h->rgb = h->comp[0].id == 82 && h->comp[1].id == 71 && h->comp[2].id == 66;
  }
  if (!h->arith && !h->progressive) {
    // jdhuff.c's jinit_huff_decoder (sequential only; jdphuff.c has no
    // such step): the standard tables where the file defined none
    // (motion-JPEG frames), before the first scan
    std_huff(kStdDcLuma, 12, false, &h->dc[0]);
    std_huff(kStdAcLuma, 162, true, &h->ac[0]);
    std_huff(kStdDcChroma, 12, false, &h->dc[1]);
    std_huff(kStdAcChroma, 162, true, &h->ac[1]);
  }
  h->multi_scan = h->progressive || h->scan.ncomp != h->ncomp;
  return check_scan(h);
}

inline int ceil_div(long a, long b) { return int((a + b - 1) / b); }

// A component's blocks: the MCU-padded grid of an interleaved image, a
// one-component image's own blocks.
inline int blocks_w(const Header& h, int c) {
  if (h.ncomp == 1) return ceil_div(ceil_div(long(h.width) * h.comp[c].h, h.max_h), 8);
  return ceil_div(h.width, 8 * h.max_h) * h.comp[c].h;
}

inline int blocks_h(const Header& h, int c) {
  if (h.ncomp == 1) return ceil_div(ceil_div(long(h.height) * h.comp[c].v, h.max_v), 8);
  return ceil_div(h.height, 8 * h.max_v) * h.comp[c].v;
}

// The coefficients a side that the IDCT of size s reads, and the index of
// place i of its kept square (data/jpeg_plain.py's kept and kept_index).
inline int kept(int s) { return s == 2 ? 5 : s == 4 ? 7 : std::min(s, 8); }
inline int kept_index(int s, int i) { return s == 2 ? (i == 0 ? 0 : 2 * i - 1) : s == 4 && i >= 4 ? i + 1 : i; }

// The kept square of an s x s IDCT's blocks: k a side, and for each of its
// places the index in the natural-order block (kept_index of its row and
// column), or rows: the square is the block's top-left one.
struct Cut {
  int k = 8;
  bool rows = true;
  uint8_t from[64];
  explicit Cut(int s = 8) : k(kept(s)), rows(s != 2 && s != 4) {
    for (int r = 0; r < k; ++r)
      for (int c = 0; c < k; ++c) from[r * k + c] = uint8_t(8 * kept_index(s, r) + kept_index(s, c));
  }
};

// A natural-order block's kept square into out.
inline void cut_block(const int16_t* blk, const Cut& cut, int16_t* out) {
  const int k = cut.k;
  if (cut.rows) {
    for (int r = 0; r < k; ++r) std::memcpy(out + r * k, blk + 8 * r, sizeof(int16_t) * k);
  } else {
    for (int i = 0; i < k * k; ++i) out[i] = blk[cut.from[i]];
  }
}

// Layout of the coefficients at scale_n/8 (libjpeg-turbo's choice of each
// component's IDCT size, its downsampled sizes and the output size).
bool fill_meta(const Header& h, int scale_n, int32_t* meta) {
  std::memset(meta, 0, sizeof(int32_t) * META_INTS);
  meta[M_WIDTH] = h.width;
  meta[M_HEIGHT] = h.height;
  meta[M_NCOMP] = h.ncomp;
  meta[M_MAX_H] = h.max_h;
  meta[M_MAX_V] = h.max_v;
  meta[M_OUT_W] = ceil_div(long(h.width) * scale_n, 8);
  meta[M_OUT_H] = ceil_div(long(h.height) * scale_n, 8);
  meta[M_SCALE] = scale_n;
  meta[M_COLOR] = h.ncomp == 1 ? COLOR_GREY : h.rgb ? COLOR_RGB : COLOR_YCC;
  meta[M_RESTART] = h.restart_interval;
  meta[M_SOF] = h.sof;
  long off = 0;
  for (int c = 0; c < h.ncomp; ++c) {
    const Comp& cp = h.comp[c];
    int32_t* m = meta + COMP_BASE + COMP_INTS * c;
    int ssize = scale_n;
    while (ssize < 8 && (h.max_h * scale_n) % (cp.h * ssize * 2) == 0 &&
           (h.max_v * scale_n) % (cp.v * ssize * 2) == 0)
      ssize *= 2;
    const int k = kept(ssize);
    const int bw = blocks_w(h, c), bh = blocks_h(h, c);
    m[C_H] = cp.h;
    m[C_V] = cp.v;
    m[C_S] = ssize;
    m[C_K] = k;
    m[C_BW] = bw;
    m[C_BH] = bh;
    m[C_OFF] = int32_t(off);
    m[C_DW] = ceil_div(long(h.width) * cp.h * ssize, long(h.max_h) * 8);
    m[C_DH] = ceil_div(long(h.height) * cp.v * ssize, long(h.max_v) * 8);
    for (int i = 0; i < 64; ++i) m[COMP_QT + i] = h.latched[c][i];
    off += long(bw) * bh * k * k;
    if (off > 0x7FFFFFFFL) return false;
  }
  meta[M_COEFS] = int32_t(off);
  return true;
}

// ---------------------------------------------------------------- Huffman

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int fake = 0;         // zero bits fed past the marker
  bool marker = false;  // reached a marker (or the end): zeros follow, as libjpeg feeds them

  inline void fill() {
    if (bits > 56) return;
    if (!marker && p + 8 <= end) {
      // whole bytes at once while none of the next eight is 0xFF
      uint64_t w;
      std::memcpy(&w, p, 8);
      uint64_t x = ~w;
      if (((x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL) == 0) {
        int nb = (63 - bits) >> 3;
        if (nb > 0) {
          buf = (buf << (8 * nb)) | (__builtin_bswap64(w) >> (64 - 8 * nb));
          bits += 8 * nb;
          p += nb;
        }
      }
    }
    while (bits <= 56) {
      uint32_t c = 0;
      if (!marker) {
        if (p < end) {
          c = *p++;
          if (c == 0xFF) {
            while (p < end && *p == 0xFF) ++p;
            if (p < end && *p == 0x00) {
              ++p;
            } else {
              marker = true;
              --p;  // at an 0xFF before the marker code
              c = 0;
            }
          }
        } else {
          marker = true;
        }
      }
      if (marker) fake += 8;
      buf = (buf << 8) | c;
      bits += 8;
    }
  }
  // The decoder has read a bit past the data (libjpeg's insufficient_data).
  inline bool out_of_data() const { return bits < fake; }
  inline int get(int s) {
    int v = int((buf >> (bits - s)) & ((1u << s) - 1));
    bits -= s;
    return v;
  }
  // At least 32 bits: one code (<= 16) and its extra bits (<= 15).
  inline void ensure() {
    if (bits < 32) fill();
  }
  inline int bit() {
    ensure();
    return get(1);
  }
  inline int decode(const Huff& h) {
    ensure();
    int e = h.look[(buf >> (bits - kLook)) & ((1 << kLook) - 1)];
    if (e) {
      bits -= e >> 8;
      return e & 0xFF;
    }
    for (int l = kLook + 1; l <= 16; ++l) {
      int32_t code = int32_t((buf >> (bits - l)) & ((1u << l) - 1));
      if (code <= h.maxcode[l]) {
        bits -= l;
        return h.huffval[(h.valoffset[l] + code) & 0xFF];
      }
    }
    bits -= 16;  // no such code: libjpeg warns and takes 0
    return 0;
  }
  // Restart: drop the buffered bits, find the marker and pass an RSTn.
  // Returns whether it passed one (libjpeg then reads data again).
  bool restart() {
    buf = 0;
    bits = 0;
    fake = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) ++p;
    }
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      marker = false;
      return true;
    }
    if (p + 1 >= end) marker = true;
    return false;
  }
};

// One sequential block (jdhuff.c's decode_mcu) into blk, natural order,
// writing its DC and its nonzero ACs over what blk holds.
inline void sequential_block(BitReader& br, const Huff& dc, const Huff& ac, int& pred, int16_t* blk) {
  int s = br.decode(dc);
  if (s) pred += extend(br.get(s), s);
  blk[0] = int16_t(pred);
  for (int k = 1; k < 64;) {
    br.ensure();
    int32_t f = ac.fast_ac[(br.buf >> (br.bits - kLook)) & ((1 << kLook) - 1)];
    if (f) {
      br.bits -= f & 15;
      k += (f >> 4) & 15;
      blk[kNatural[k]] = int16_t(f >> 8);
      ++k;
      continue;
    }
    int rs = br.decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      ++k;
    } else {
      if (r != 15) break;
      k += 16;
    }
  }
}

// jdphuff.c's four block decoders. Coefficients are JCOEF (int16): shifts
// and refinements wrap as libjpeg's do.
inline void dc_first(BitReader& br, const Huff& dc, int al, int& pred, int16_t* blk) {
  int s = br.decode(dc);
  if (s) pred += extend(br.get(s), s);
  blk[0] = int16_t(uint32_t(pred) << al);
}

inline void dc_refine(BitReader& br, int al, int16_t* blk) {
  if (br.bit()) blk[0] = int16_t(blk[0] | (1 << al));
}

inline void ac_first(BitReader& br, const Huff& ac, const Scan& sc, unsigned& eobrun, int16_t* blk) {
  if (eobrun > 0) {
    --eobrun;
    return;
  }
  for (int k = sc.ss; k <= sc.se; ++k) {
    int rs = br.decode(ac), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = int16_t(uint32_t(extend(br.get(s), s)) << sc.al);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = 1u << r;
      if (r) eobrun += unsigned(br.get(r));
      --eobrun;
      break;
    }
  }
}

// A correction bit for a coefficient already nonzero: 1 moves it one step
// of the bit being coded away from zero (once).
inline void correct(BitReader& br, int p1, int16_t* c) {
  if (br.bit() && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c - p1);
}

inline void ac_refine(BitReader& br, const Huff& ac, const Scan& sc, unsigned& eobrun, int16_t* blk) {
  const int p1 = 1 << sc.al;
  int k = sc.ss;
  if (eobrun == 0) {
    for (; k <= sc.se; ++k) {
      int rs = br.decode(ac), r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.bit() ? p1 : -p1;  // the newly nonzero coefficient's sign
      } else if (r != 15) {
        eobrun = 1u << r;
        if (r) eobrun += unsigned(br.get(r));
        break;
      }
      // pass the nonzero coefficients (each takes a correction bit) and r
      // zero ones; a new coefficient lands on the next zero
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          correct(br, p1, c);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = int16_t(s);
    }
  }
  if (eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0) correct(br, p1, c);
    }
    --eobrun;
  }
}

// ---------------------------------------------------------------- arithmetic

// kAriTab: tiff_decode.h (defined after the anonymous namespace).

// jdarith.c's decoder state: the C and A registers, the bit counter ct (-16
// before the first two bytes, -1 after a decoding error, which stops the
// decoders but DC refinement until the next restart), and the statistics
// bins of each table (reset per scan and restart), the DC predictions and
// contexts of each scan component, the fixed 0.5 bin.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool marker = false;  // reached a marker or the end: zeros follow (legal in arithmetic coding)
  uint8_t dc_stats[kArithTables][64];
  uint8_t ac_stats[kArithTables][256];
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  uint8_t fixed_bin = 113;

  inline int next_byte() {
    if (marker || p >= end) {
      marker = true;
      return 0;
    }
    int data = *p++;
    if (data == 0xFF) {
      while (p < end && *p == 0xFF) ++p;
      if (p < end && *p == 0) {
        ++p;
      } else {
        marker = true;
        --p;  // at an 0xFF before the marker code
        data = 0;
      }
    }
    return data;
  }
  // arith_decode: one binary decision in the bin st (0 or 1).
  inline int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes: a is 0x10000 after the shift
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  inline bool out_of_data() const { return false; }  // libjpeg never flags it for arithmetic data
  // process_restart's reading half: pass the RSTn, restart the registers.
  bool restart() {
    c = a = 0;
    ct = -16;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) ++p;
    }
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      marker = false;
      return true;
    }
    marker = true;
    return false;
  }
  // The statistics of the scan's components (start_pass and process_restart).
  void reset(const Header& h) {
    const Scan& sc = h.scan;
    for (int i = 0; i < sc.ncomp; ++i) {
      const Comp& cp = h.comp[sc.comp[i]];
      if (!h.progressive || (sc.ss == 0 && sc.ah == 0)) {
        std::memset(dc_stats[cp.td], 0, sizeof(dc_stats[cp.td]));
        last_dc[i] = dc_context[i] = 0;
      }
      if (!h.progressive || sc.ss) std::memset(ac_stats[cp.ta], 0, sizeof(ac_stats[cp.ta]));
    }
  }
};

// A DC difference (Figures F.19-F.24) of scan component ci into its
// prediction. False on a magnitude overflow (ct = -1).
inline bool arith_dc(ArithReader& ar, const Header& h, int tbl, int ci) {
  uint8_t* st = ar.dc_stats[tbl] + ar.dc_context[ci];
  if (ar.decode(st) == 0) {
    ar.dc_context[ci] = 0;
    return true;
  }
  const int sign = ar.decode(st + 1);
  st += 2 + sign;
  int m = ar.decode(st);
  if (m != 0) {
    st = ar.dc_stats[tbl] + 20;
    while (ar.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar.ct = -1;
        return false;
      }
      st += 1;
    }
  }
  if (m < ((1 << h.dc_l[tbl]) >> 1)) ar.dc_context[ci] = 0;
  else if (m > ((1 << h.dc_u[tbl]) >> 1)) ar.dc_context[ci] = 12 + sign * 4;
  else ar.dc_context[ci] = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (ar.decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  ar.last_dc[ci] = (ar.last_dc[ci] + v) & 0xffff;
  return true;
}

// AC coefficients ss..se (Figure F.20) into blk, each shifted by al.
inline void arith_ac(ArithReader& ar, const Header& h, int tbl, int ss, int se, int al, int16_t* blk) {
  for (int k = ss; k <= se; k++) {
    uint8_t* st = ar.ac_stats[tbl] + 3 * (k - 1);
    if (ar.decode(st)) break;  // EOB
    while (ar.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        ar.ct = -1;  // spectral overflow
        return;
      }
    }
    const int sign = ar.decode(&ar.fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0) {
      if (ar.decode(st)) {
        m <<= 1;
        st = ar.ac_stats[tbl] + (k <= h.ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = int16_t(uint32_t(v) << al);
  }
}

// One sequential block (jdarith.c's decode_mcu), scan component ci.
inline void arith_sequential(ArithReader& ar, const Header& h, const Comp& cp, int ci, int16_t* blk) {
  if (ar.ct == -1) return;
  if (!arith_dc(ar, h, cp.td, ci)) return;
  blk[0] = int16_t(ar.last_dc[ci]);
  arith_ac(ar, h, cp.ta, 1, 63, 0, blk);
}

// jdarith.c's progressive decoders.
inline void arith_dc_first(ArithReader& ar, const Header& h, const Comp& cp, int ci, int al, int16_t* blk) {
  if (ar.ct == -1) return;
  if (!arith_dc(ar, h, cp.td, ci)) return;
  blk[0] = int16_t(uint32_t(ar.last_dc[ci]) << al);
}

inline void arith_dc_refine(ArithReader& ar, int al, int16_t* blk) {
  if (ar.decode(&ar.fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
}

inline void arith_ac_refine(ArithReader& ar, int tbl, const Scan& sc, int16_t* blk) {
  if (ar.ct == -1) return;
  const int p1 = 1 << sc.al, m1 = -p1;
  int kex = sc.se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = sc.ss; k <= sc.se; k++) {
    uint8_t* st = ar.ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && ar.decode(st)) break;  // EOB
    for (;;) {
      int16_t* c = blk + kNatural[k];
      if (*c) {  // previously nonzero: a correction bit
        if (ar.decode(st + 2)) *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
        break;
      }
      if (ar.decode(st + 1)) {  // newly nonzero
        *c = int16_t(ar.decode(&ar.fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > sc.se) {
        ar.ct = -1;  // spectral overflow
        return;
      }
    }
  }
}

// ---------------------------------------------------------------- scans

// Walk a scan's MCUs from h.scan_start, calling block(i, by, bx, decode)
// for each block (i its component's place in the scan) after each MCU's
// restart handling (reset() drops the predictions, EOB run and statistics).
// Once the reader has read past the data, the rest of the restart interval
// is called with decode false (jdhuff.c's insufficient_data: libjpeg leaves
// those MCUs as they were). A non-interleaved scan covers its component's
// own blocks; an interleaved one the MCU grid. Returns the last iMCU row
// started with data left (jdcoefct.c's last_good_iMCU_row).
template <class Reader, class Block, class Reset>
int walk_mcus(Reader& br, const Header& h, Block block, Reset reset) {
  const Scan& sc = h.scan;
  int restarts_to_go = h.restart_interval;
  bool insufficient = false;
  int last_good = 0;
  auto mcu_start = [&](int imcu_row) {
    if (h.restart_interval) {
      if (restarts_to_go == 0) {
        if (br.restart()) insufficient = false;
        reset();
        restarts_to_go = h.restart_interval;
      }
      --restarts_to_go;
    }
    if (!insufficient) last_good = imcu_row;
    return !insufficient;
  };
  if (sc.ncomp == 1) {
    const int c = sc.comp[0];
    const Comp& cp = h.comp[c];
    const int bw = ceil_div(long(h.width) * cp.h, 8L * h.max_h), bh = ceil_div(long(h.height) * cp.v, 8L * h.max_v);
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        const bool decode = mcu_start(by / cp.v);
        block(0, by, bx, decode);
        if (decode && br.out_of_data()) insufficient = true;
      }
  } else {
    const int mcux = ceil_div(h.width, 8 * h.max_h), mcuy = ceil_div(h.height, 8 * h.max_v);
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        const bool decode = mcu_start(my);
        for (int i = 0; i < sc.ncomp; ++i) {
          const Comp& cp = h.comp[sc.comp[i]];
          for (int v = 0; v < cp.v; ++v)
            for (int u = 0; u < cp.h; ++u) block(i, my * cp.v + v, mx * cp.h + u, decode);
        }
        if (decode && br.out_of_data()) insufficient = true;
      }
  }
  return last_good;
}

// One scan of a sequential file's blocks, each by out(c, by, bx) (a
// natural-order block, zeroed for the direct path, the whole-block buffer
// for several scans) and done(c, by, bx) after it; returns where the reader
// stopped, for the markers that follow.
template <class Out, class Done>
size_t sequential_scan(const uint8_t* d, size_t n, const Header& h, Out out, Done done) {
  const Scan& sc = h.scan;
  if (h.arith) {
    ArithReader ar;
    ar.p = d + h.scan_start;
    ar.end = d + n;
    ar.reset(h);
    walk_mcus(
        ar, h,
        [&](int i, int by, int bx, bool decode) {
          const int c = sc.comp[i];
          int16_t* blk = out(c, by, bx);
          if (decode) arith_sequential(ar, h, h.comp[c], i, blk);
          done(c, by, bx);
        },
        [&]() { ar.reset(h); });
    return size_t(ar.p - d);
  }
  BitReader br;
  br.p = d + h.scan_start;
  br.end = d + n;
  int pred[3] = {0, 0, 0};
  walk_mcus(
      br, h,
      [&](int i, int by, int bx, bool decode) {
        const int c = sc.comp[i];
        const Comp& cp = h.comp[c];
        int16_t* blk = out(c, by, bx);
        if (decode) sequential_block(br, h.dc[cp.td], h.ac[cp.ta], pred[c], blk);
        done(c, by, bx);
      },
      [&]() { pred[0] = pred[1] = pred[2] = 0; });
  return size_t(br.p - d);
}

// Entropy-decode a one-scan image into coef (meta's layout): a block kept
// whole straight into its place, any other into a scratch block, then its
// kept square out. Then (unless scan_only) the markers after the scan, as
// jpeg_finish_decompress reads them: another scan, or markers that do not
// parse, make libjpeg refuse the file. Returns a Kind.
int decode_scan(const uint8_t* d, size_t n, Header* h, const int32_t* meta, int16_t* coef, bool scan_only) {
  Cut cut[3];
  int BW[3], KK[3];
  int16_t* base[3];
  for (int c = 0; c < h->ncomp; ++c) {
    const int32_t* m = meta + COMP_BASE + COMP_INTS * c;
    cut[c] = Cut(m[C_S]);
    KK[c] = m[C_K] * m[C_K];
    BW[c] = m[C_BW];
    base[c] = coef + m[C_OFF];
  }
  alignas(16) int16_t blk[64];
  size_t pos;
  if (h->arith) {
    int16_t* dst = blk;
    pos = sequential_scan(
        d, n, *h,
        [&](int c, int by, int bx) {
          int16_t* out = base[c] + (long(by) * BW[c] + bx) * KK[c];
          dst = KK[c] == 64 ? out : blk;
          std::memset(dst, 0, sizeof(blk));
          return dst;
        },
        [&](int c, int by, int bx) {
          if (dst == blk) cut_block(blk, cut[c], base[c] + (long(by) * BW[c] + bx) * KK[c]);
        });
  } else {  // the hot path: the Huffman decoder inline
    BitReader br;
    br.p = d + h->scan_start;
    br.end = d + n;
    int pred[3] = {0, 0, 0};
    const Header& hh = *h;
    walk_mcus(
        br, hh,
        [&](int i, int by, int bx, bool decode) {
          const int c = hh.scan.comp[i];
          const Comp& cp = hh.comp[c];
          int16_t* out = base[c] + (long(by) * BW[c] + bx) * KK[c];
          int16_t* dst = KK[c] == 64 ? out : blk;
          std::memset(dst, 0, sizeof(blk));
          if (decode) sequential_block(br, hh.dc[cp.td], hh.ac[cp.ta], pred[c], dst);
          if (dst == blk) cut_block(blk, cut[c], out);
        },
        [&]() { pred[0] = pred[1] = pred[2] = 0; });
    pos = size_t(br.p - d);
  }
  if (scan_only) return KIND_BASELINE;
  const int kind = read_markers(d, n, &pos, h);
  return kind == KIND_END ? KIND_BASELINE : kind == KIND_BASELINE ? KIND_UNREADABLE : kind;
}

// The progression status of a progressive file (jdphuff.c's and
// jdarith.c's coef_bits): per component and coefficient (zigzag order) the
// Al of the last scan that coded it, -1 before any; prev, the status before
// the component's last scan (for coefficients 1..9 and that scan's band);
// the scans read; the last iMCU row the last scan started with data left.
struct Progress {
  int cur[3][64];
  int prev[3][64];
  int scans = 0;
  int last_good = 0;
  Progress() {
    std::fill(&cur[0][0], &cur[0][0] + 3 * 64, -1);
    std::fill(&prev[0][0], &prev[0][0] + 3 * 64, 0);
  }
  void start(const Scan& sc) {
    ++scans;
    for (int i = 0; i < sc.ncomp; ++i) {
      const int c = sc.comp[i];
      for (int k = std::min(sc.ss, 1); k <= std::max(sc.se, 9); ++k) prev[c][k] = scans > 1 ? cur[c][k] : 0;
      for (int k = sc.ss; k <= sc.se; ++k) cur[c][k] = sc.al;
    }
  }
};

// One estimate of jdcoefct.c's block smoothing: num / (q << 8), rounded,
// clamped below 2^al where al > 0, as a JCOEF.
inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return int16_t(num >= 0 ? pred : -pred);
}

// libjpeg-turbo 2.1.5's block smoothing (jdcoefct.c's smoothing_ok and
// decompress_smooth_data) over the whole blocks of a progressive image:
// where a component's coefficients 1..9 are not all known to full
// precision, each block's still-zero ones among them are estimated from the
// DC values of its 5 x 5 neighbourhood (and, where no AC data came at all,
// the DC too), with the neighbourhood clamped at the image's edges as
// libjpeg clamps its sliding window. Rows past the last iMCU row that the
// last scan reached with data take the status before that scan.
void smooth_blocks(const Header& h, const Progress& pg, int16_t* const base[3], const int bw[3], const int bh[3]) {
  static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // natural order of zigzag 0..9
  int latch[3][10], prev_latch[3][10];
  bool useful = false;
  for (int c = 0; c < h.ncomp; ++c) {
    if (!h.is_latched[c]) return;
    for (int k = 0; k < 10; ++k)
      if (h.latched[c][kQPos[k]] == 0) return;
    if (pg.cur[c][0] < 0) return;
    latch[c][0] = prev_latch[c][0] = pg.cur[c][0];
    for (int k = 1; k < 10; ++k) {
      prev_latch[c][k] = pg.scans > 1 ? pg.prev[c][k] : -1;
      latch[c][k] = pg.cur[c][k];
      if (latch[c][k] != 0) useful = true;
    }
  }
  if (!useful) return;
  const int total = ceil_div(h.height, 8 * h.max_v);  // iMCU rows
  std::vector<int> dcs;
  for (int c = 0; c < h.ncomp; ++c) {
    const Comp& cp = h.comp[c];
    const int wb = ceil_div(ceil_div(long(h.width) * cp.h, h.max_h), 8);   // width_in_blocks
    const int hb = ceil_div(ceil_div(long(h.height) * cp.v, h.max_v), 8);  // height_in_blocks
    const int v = cp.v, W = bw[c];
    dcs.assign(size_t(W) * bh[c], 0);
    for (size_t b = 0; b < dcs.size(); ++b) dcs[b] = base[c][b * 64];
    // a block row past the buffer is libjpeg's pre-zeroed padding
    auto dc = [&](int row, int col) { return row < bh[c] ? dcs[size_t(row) * W + col] : 0; };
    const uint16_t* q = h.latched[c];
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
    const int64_t Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    for (int L = 0; L < total; ++L) {
      const int* bits = L > pg.last_good ? prev_latch[c] : latch[c];
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
      int b = v;  // block rows of this iMCU row
      if (L == total - 1) {
        b = hb % v;
        if (b == 0) b = v;
      }
      for (int r = 0; r < b; ++r) {
        // the window's rows, clamped by iMCU row as libjpeg clamps them
        const int cur = L * v + r;
        const int prev = r > 0 || L > 0 ? cur - 1 : cur;
        const int pprev = r > 1 || L > 1 ? cur - 2 : prev;
        const int next = r < b - 1 || L < total - 1 ? cur + 1 : cur;
        const int nnext = r < b - 2 || L + 1 < total - 1 ? cur + 2 : next;
        const int rows[5] = {pprev, prev, cur, next, nnext};
        int D[5][5];  // D[i][j]: libjpeg's DC(5i + j + 1)
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) D[i][j] = dc(rows[i], 0);
        const int last_col = wb - 1;
        for (int col = 0; col <= last_col; ++col) {
          if (col == 0 && col < last_col)
            for (int i = 0; i < 5; ++i) D[i][3] = dc(rows[i], 1);
          if (col + 1 < last_col)
            for (int i = 0; i < 5; ++i) D[i][4] = dc(rows[i], col + 2);
          const int64_t DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3], DC05 = D[0][4];
          const int64_t DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3], DC10 = D[1][4];
          const int64_t DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4];
          const int64_t DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4];
          const int64_t DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3], DC25 = D[4][4];
          int16_t* w = base[c] + (size_t(cur) * W + col) * 64;
          int al;
          if ((al = bits[1]) != 0 && w[1] == 0)
            w[1] = smooth_pred(Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                                   3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                                   3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                                   DC24 + DC25)
                                                : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                               Q01, al);
          if ((al = bits[2]) != 0 && w[8] == 0)
            w[8] = smooth_pred(Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                                   38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                                   13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                                : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                               Q10, al);
          if ((al = bits[3]) != 0 && w[16] == 0)
            w[16] = smooth_pred(Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                                    5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                                 : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                                Q20, al);
          if ((al = bits[4]) != 0 && w[9] == 0)
            w[9] = smooth_pred(Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                                   DC25)
                                                : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                                                   DC04 - DC06 + 10 * DC07 - 10 * DC09)),
                               Q11, al);
          if ((al = bits[5]) != 0 && w[2] == 0)
            w[2] = smooth_pred(Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                                   7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                                : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                               Q02, al);
          if (change_dc) {
            if ((al = bits[6]) != 0 && w[3] == 0)
              w[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
            if ((al = bits[7]) != 0 && w[10] == 0)
              w[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
            if ((al = bits[8]) != 0 && w[17] == 0)
              w[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
            if ((al = bits[9]) != 0 && w[24] == 0)
              w[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
            w[0] = smooth_pred(Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                      42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                      42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                      6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                               Q00, 0);
          }
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) D[i][j] = D[i][j + 1];
        }
      }
    }
  }
}

// Walk every scan of a multi-scan image, from the one in h->scan on: given
// full (each component's blocks_w x blocks_h blocks of 64 coefficients,
// natural order, zeroed) each scan is decoded into it, and a progressive
// image's blocks are smoothed after the last; given nullptr only the
// markers are read. Returns KIND_BASELINE, or the Kind a later scan gives
// the file.
int walk_scans(const uint8_t* d, size_t n, Header* h, int16_t* full) {
  Progress pg;
  int16_t* base[3] = {full, full, full};
  int bw[3] = {0, 0, 0}, bh[3] = {0, 0, 0};
  for (int c = 0; c < h->ncomp; ++c) {
    bw[c] = blocks_w(*h, c);
    bh[c] = blocks_h(*h, c);
    if (full != nullptr && c + 1 < h->ncomp) base[c + 1] = base[c] + long(bw[c]) * bh[c] * 64;
  }
  size_t pos = h->scan_start;
  while (true) {
    const Scan& sc = h->scan;
    if (h->progressive) pg.start(sc);
    if (full != nullptr) {
      const Header& hh = *h;
      auto at = [&](int c, int by, int bx) { return base[c] + (long(by) * bw[c] + bx) * 64; };
      if (!hh.progressive) {
        sequential_scan(d, n, hh, at, [](int, int, int) {});
      } else if (hh.arith) {
        ArithReader ar;
        ar.p = d + hh.scan_start;
        ar.end = d + n;
        ar.reset(hh);
        pg.last_good = walk_mcus(
            ar, hh,
            [&](int i, int by, int bx, bool) {
              const int c = sc.comp[i];
              const Comp& cp = hh.comp[c];
              int16_t* blk = at(c, by, bx);
              if (sc.ss == 0 && sc.ah == 0) arith_dc_first(ar, hh, cp, i, sc.al, blk);
              else if (sc.ss == 0) arith_dc_refine(ar, sc.al, blk);
              else if (sc.ah == 0) {
                if (ar.ct != -1) arith_ac(ar, hh, cp.ta, sc.ss, sc.se, sc.al, blk);
              } else arith_ac_refine(ar, cp.ta, sc, blk);
            },
            [&]() { ar.reset(hh); });
      } else {
        BitReader br;
        br.p = d + hh.scan_start;
        br.end = d + n;
        int pred[3] = {0, 0, 0};
        unsigned eobrun = 0;
        pg.last_good = walk_mcus(
            br, hh,
            [&](int i, int by, int bx, bool decode) {
              const int c = sc.comp[i];
              const Comp& cp = hh.comp[c];
              int16_t* blk = at(c, by, bx);
              if (!decode) return;
              if (sc.ss == 0 && sc.ah == 0) dc_first(br, hh.dc[cp.td], sc.al, pred[c], blk);
              else if (sc.ss == 0) dc_refine(br, sc.al, blk);
              else if (sc.ah == 0) ac_first(br, hh.ac[cp.ta], sc, eobrun, blk);
              else ac_refine(br, hh.ac[cp.ta], sc, eobrun, blk);
            },
            [&]() {
              pred[0] = pred[1] = pred[2] = 0;
              eobrun = 0;
            });
      }
    }
    int kind = read_markers(d, n, &pos, h);
    if (kind == KIND_END) break;
    if (kind == KIND_BASELINE) kind = check_scan(h);
    if (kind != KIND_BASELINE) return kind;
  }
  if (full != nullptr && h->progressive) smooth_blocks(*h, pg, base, bw, bh);
  return KIND_BASELINE;
}

// A file's bytes: read into memory, or from kMapBytes on (a TIFF
// download) mapped read-only, as libtiff maps what it reads, with no copy.
constexpr size_t kMapBytes = size_t(4) << 20;

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  void* map = nullptr;
  std::unique_ptr<uint8_t[]> owned;

  bool open(const char* path) {
    const int fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return false;
    struct stat st;
    bool ok = fstat(fd, &st) == 0 && S_ISREG(st.st_mode);
    if (ok && st.st_size > 0) {
      size = size_t(st.st_size);
      if (size >= kMapBytes) {
        map = mmap(nullptr, size, PROT_READ, MAP_PRIVATE | MAP_POPULATE, fd, 0);
        ok = map != MAP_FAILED;
        if (!ok) map = nullptr;
        data = static_cast<const uint8_t*>(map);
      } else {
        owned.reset(new uint8_t[size]);
        size_t got = 0;
        while (ok && got < size) {
          const ssize_t r = ::read(fd, owned.get() + got, size - got);
          ok = r > 0;
          got += ok ? size_t(r) : 0;
        }
        data = owned.get();
      }
      if (!ok) size = 0;
    }
    ::close(fd);
    return ok;
  }

  ~MappedFile() {
    if (map != nullptr) munmap(map, size);
  }
};

// A multi-scan image's coefficients into coef (meta's layout): every scan
// into whole blocks, then each block's kept square out.
int decode_multi_scan(const uint8_t* d, size_t n, const int32_t* meta, int16_t* coef) {
  Header* h = new Header();
  int kind = parse_header(d, n, h);
  if (kind == KIND_BASELINE) {
    long total = 0;
    for (int c = 0; c < h->ncomp; ++c) total += long(blocks_w(*h, c)) * blocks_h(*h, c) * 64;
    std::vector<int16_t> full(size_t(total), 0);
    kind = walk_scans(d, n, h, full.data());
    const int16_t* src = full.data();
    for (int c = 0; kind == KIND_BASELINE && c < h->ncomp; ++c) {
      const int32_t* m = meta + COMP_BASE + COMP_INTS * c;
      const Cut cut(m[C_S]);
      const long blocks = long(m[C_BW]) * m[C_BH];
      int16_t* out = coef + m[C_OFF];
      for (long b = 0; b < blocks; ++b, src += 64, out += cut.k * cut.k) cut_block(src, cut, out);
    }
  }
  delete h;
  return kind;
}

// Probe (coef == nullptr) or decode one in-memory file. Returns the Kind,
// or -2 if cap (int16 units) is too small for the coefficients. A one-scan
// file's markers after its scan are read by the decode (unless scan_only),
// not the probe.
int decode_bytes(const uint8_t* d, size_t n, int scale_n, int32_t* meta, int16_t* coef, long cap,
                 bool scan_only = false) {
  Header* h = new Header();
  int kind = parse_header(d, n, h);
  if (kind == KIND_BASELINE && h->multi_scan) kind = walk_scans(d, n, h, nullptr);
  if (kind == KIND_BASELINE && !fill_meta(*h, scale_n, meta)) kind = KIND_REFUSED;  // past 2^31 coefficients
  if (kind == KIND_BASELINE && coef != nullptr) {
    if (cap < meta[M_COEFS]) {
      kind = -2;
    } else if (h->multi_scan) {
      kind = decode_multi_scan(d, n, meta, coef);
    } else {
      kind = decode_scan(d, n, h, meta, coef, scan_only);
    }
  }
  if (kind != KIND_BASELINE && kind != -2) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    if (kind == KIND_REFUSED) {
      meta[M_WIDTH] = h->width;
      meta[M_HEIGHT] = h->height;
      meta[M_SOF] = h->sof;
    }
  }
  meta[M_KIND] = kind;
  delete h;
  return kind;
}

// ---------------------------------------------------------------- loader

// One file as a worker left it: a JPEG's coefficients, or a TIFF as
// read_tiff gives it (pixels, or JPEG segments and their coefficients).
struct Record {
  int32_t meta[META_INTS];
  std::vector<int16_t> coef;
  Bytes rgb;
  std::vector<int32_t> metas;

  size_t bytes() const { return coef.size() * sizeof(int16_t) + rgb.size + metas.size() * sizeof(int32_t); }
};

// Decode a file's bytes as the loader hands it out: a TIFF's pixels only
// at 8/8 (at scale the caller resizes TIFFs another way).
void decode_record(const uint8_t* d, size_t n, int scale_n, Record* rec) {
  int kind = decode_bytes(d, n, scale_n, rec->meta, nullptr, 0);
  if (kind == KIND_TIFF) {
    TiffImage t;
    read_tiff(d, n, scale_n == 8, &t);
    std::memcpy(rec->meta, t.meta, sizeof(rec->meta));
    rec->rgb = std::move(t.rgb);
    rec->metas = std::move(t.metas);
    rec->coef = std::move(t.coef);
  } else if (kind == KIND_BASELINE) {
    rec->coef.resize(size_t(rec->meta[M_COEFS]));
    kind = decode_bytes(d, n, scale_n, rec->meta, rec->coef.data(), long(rec->coef.size()));
    if (kind != KIND_BASELINE) rec->coef.clear();
  }
}

// Decoded bytes the workers may hold ahead of the caller (besides the file
// it waits for): a 6144 px raster is 113 MB.
constexpr size_t kAheadBytes = size_t(1) << 30;

struct Loader {
  std::vector<std::string> paths;
  int scale_n = 8;
  size_t depth = 16;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Record*> done;
  size_t next_claim = 0, next_emit = 0, held = 0;
  bool stopping = false;
  std::vector<std::thread> workers;

  void worker() {
    while (true) {
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stopping || (next_claim < next_emit + depth && (held < kAheadBytes || next_claim == next_emit));
        });
        if (stopping || next_claim >= paths.size()) return;
        i = next_claim++;
      }
      Record* rec = new Record();
      MappedFile file;
      if (!file.open(paths[i].c_str())) {
        std::memset(rec->meta, 0, sizeof(rec->meta));
        rec->meta[M_KIND] = KIND_UNREADABLE;
      } else {
        decode_record(file.data, file.size, scale_n, rec);
      }
      std::lock_guard<std::mutex> lk(mu);
      done[i] = rec;
      held += rec->bytes();
      cv_ready.notify_all();
    }
  }

  // The peeked record (nullptr if none), under mu.
  Record* current() {
    auto it = done.find(next_emit);
    return it == done.end() ? nullptr : it->second;
  }

  ~Loader() {
    for (auto& kv : done) delete kv.second;
  }
};

}  // namespace

namespace aq {

// T.81 Table D.2 in jaricom.c's layout (tiff_decode.h).
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719, 0x006f081c,
    0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024,
    0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c,
    0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
    0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d,
    0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b, 0x0bb64f4d, 0x0a40304d,
    0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756,
    0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b,
    0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

int decode_jpeg_segment(const uint8_t* tables, size_t tlen, const uint8_t* d, size_t n, int32_t* meta,
                        std::vector<int16_t>* coef) {
  if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) {  // jpeg_read_header: not a JPEG stream
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    return meta[M_KIND] = KIND_UNREADABLE;
  }
  // the tables' stream without its EOI, then the segment's without its SOI:
  // libjpeg reads the one and then the other into the same state
  std::vector<uint8_t> joined;
  if (tables != nullptr) {
    const size_t tl = tlen >= 2 && tables[tlen - 2] == 0xFF && tables[tlen - 1] == 0xD9 ? tlen - 2 : tlen;
    joined.reserve(tl + n - 2);
    joined.insert(joined.end(), tables, tables + tl);
    joined.insert(joined.end(), d + 2, d + n);
    d = joined.data();
    n = joined.size();
  }
  int kind = decode_bytes(d, n, 8, meta, nullptr, 0);
  if (kind != KIND_BASELINE || coef == nullptr) return kind;
  const size_t at = coef->size();
  coef->resize(at + size_t(meta[M_COEFS]));
  // libtiff keeps a segment's rows when jpeg_finish_decompress then fails
  kind = decode_bytes(d, n, 8, meta, coef->data() + at, long(meta[M_COEFS]), true);
  if (kind != KIND_BASELINE) coef->resize(at);
  return kind;
}

}  // namespace aq

extern "C" {

int aq_jpeg_meta_ints() { return META_INTS; }

// Classify one file and fill its metadata at scale_n/8, without decoding
// (a TIFF's route and size from its tags and segment headers).
int aq_jpeg_probe(const char* path, int scale_n, int32_t* meta) {
  MappedFile file;
  if (!file.open(path)) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    return meta[M_KIND] = KIND_UNREADABLE;
  }
  const int kind = decode_bytes(file.data, file.size, scale_n, meta, nullptr, 0);
  if (kind == KIND_TIFF) {
    TiffImage t;
    read_tiff(file.data, file.size, false, &t);
    std::memcpy(meta, t.meta, sizeof(int32_t) * META_INTS);
  }
  return kind;
}

// Decode one file's coefficients into coef (cap int16 values). Returns the
// Kind (coefficients written only for KIND_BASELINE) or -2 if cap is short.
int aq_jpeg_decode(const char* path, int scale_n, int32_t* meta, int16_t* coef, long cap) {
  MappedFile file;
  if (!file.open(path)) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    return meta[M_KIND] = KIND_UNREADABLE;
  }
  return decode_bytes(file.data, file.size, scale_n, meta, coef, cap);
}

void* aq_jpeg_loader_create(const char** paths, int n_paths, int scale_n, int n_threads, int depth) {
  if (n_paths < 0 || scale_n < 1 || scale_n > 8) return nullptr;
  auto* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->scale_n = scale_n;
  l->depth = size_t(depth > 0 ? depth : 16);
  int nt = n_threads > 0 ? n_threads : int(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, 64));
  for (int i = 0; i < nt; ++i) l->workers.emplace_back(&Loader::worker, l);
  return l;
}

// Wait for the next file in path order and copy its metadata. Returns 1
// (meta and path_idx written), 0 at the end, -1 for a null handle.
int aq_jpeg_loader_peek(void* handle, int32_t* meta, int32_t* path_idx) {
  if (handle == nullptr) return -1;
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  if (l->next_emit >= l->paths.size()) return 0;
  l->cv_ready.wait(lk, [&] { return l->stopping || l->done.count(l->next_emit) > 0; });
  if (l->stopping) return 0;
  std::memcpy(meta, l->done[l->next_emit]->meta, sizeof(int32_t) * META_INTS);
  *path_idx = int32_t(l->next_emit);
  return 1;
}

// The peeked TIFF's JPEG segments' metadata into metas (cap segments).
// Returns the segments copied, -2 if cap is short, -1 if nothing was peeked.
int aq_jpeg_loader_segments(void* handle, int32_t* metas, int cap) {
  if (handle == nullptr) return -1;
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(l->mu);
  Record* rec = l->current();
  if (rec == nullptr) return -1;
  const size_t segs = rec->metas.size() / META_INTS;
  if (segs > size_t(cap)) return -2;
  if (segs) std::memcpy(metas, rec->metas.data(), rec->metas.size() * sizeof(int32_t));
  return int(segs);
}

// Move past the peeked file, copying its coefficients (int16, cap values)
// or its pixels (uint8, cap bytes) to dst, which may be null to drop them.
// Returns 0, -2 if cap is short (nothing popped), -1 if nothing was peeked.
static int loader_pop(void* handle, void* dst, long cap, bool pixels) {
  if (handle == nullptr) return -1;
  auto* l = static_cast<Loader*>(handle);
  Record* rec;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    rec = l->current();
    if (rec == nullptr) return -1;
    const size_t need = pixels ? rec->rgb.size : rec->coef.size();
    if (dst != nullptr && long(need) > cap) return -2;
    l->done.erase(l->next_emit);
    l->next_emit++;
    l->held -= rec->bytes();
  }
  l->cv_space.notify_all();
  if (dst != nullptr && pixels && rec->rgb.size) std::memcpy(dst, rec->rgb.data.get(), rec->rgb.size);
  if (dst != nullptr && !pixels && !rec->coef.empty())
    std::memcpy(dst, rec->coef.data(), rec->coef.size() * sizeof(int16_t));
  delete rec;
  return 0;
}

int aq_jpeg_loader_pop(void* handle, int16_t* dst, long cap) { return loader_pop(handle, dst, cap, false); }

int aq_jpeg_loader_pop_pixels(void* handle, uint8_t* dst, long cap) { return loader_pop(handle, dst, cap, true); }

// The metadata of file path_idx if a worker has read it and it is not yet
// popped: lets the caller start other decoders ahead. Returns 1, or 0.
int aq_jpeg_loader_meta(void* handle, int path_idx, int32_t* meta) {
  if (handle == nullptr || path_idx < 0) return 0;
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(l->mu);
  auto it = l->done.find(size_t(path_idx));
  if (it == l->done.end()) return 0;
  std::memcpy(meta, it->second->meta, sizeof(int32_t) * META_INTS);
  return 1;
}

void aq_jpeg_loader_destroy(void* handle) {
  if (handle == nullptr) return;
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stopping = true;
  }
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
