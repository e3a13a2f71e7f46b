// Host half of the port's JPEG decoder: marker parsing and Huffman entropy
// decode, on a thread pool, into de-zigzagged, still-quantised int16
// coefficients.
//
// Counterpart of the JPEG half of the JAX package's tileloader.cc, split another
// way: the serial part (the entropy decode) stays on host threads here, and
// the parallel part (dequantisation, IDCT, chroma upsampling, YCbCr->RGB and
// the tile grid) runs in csrc/jpeg_decode.cu on the card, or in
// data/jpeg_plain.py on the CPU. No libjpeg: the bitstream is parsed here.
//
// Decodes 8-bit Huffman-coded frames with 1 or 3 components (YCbCr by
// libjpeg's rules), sampling factors 1 or 2, restart intervals throughout:
// - sequential (SOF0/SOF1) in one interleaved scan, straight into each
//   block's kept coefficients;
// - progressive (SOF2: jdphuff.c's DC first, DC refinement, AC first with
//   its EOB runs and AC refinement with its correction bits) and sequential
//   in several scans (a first scan without every component), into whole
//   8x8 blocks scan by scan (libjpeg's pre-zeroed coefficient buffer: a
//   non-interleaved scan covers only its component's own blocks, and the
//   MCU-padding blocks keep what interleaved scans gave them), each block
//   then cut to its kept coefficients.
// Every other JPEG process (lossless, arithmetic, hierarchical, 12-bit,
// CMYK, RGB-coded) is recognised from its markers and reported as
// KIND_OTHER_JPEG with the frame's size, so that the caller routes it to
// another decoder; so is a progressive file whose scans leave one of the
// first nine AC coefficients of a component unfinished, where libjpeg
// smooths the blocks (jdcoefct.c's block smoothing). TIFF is KIND_TIFF;
// anything else, or markers that do not parse, KIND_UNREADABLE.
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
// pop / kind / destroy) whose worker threads decode files ahead of the
// caller, at most `depth` files past the oldest one not yet popped, and hand
// them out in path order.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// KIND_BASELINE: the entropy decoder takes the file (any process above)
enum Kind { KIND_BASELINE = 0, KIND_OTHER_JPEG = 1, KIND_TIFF = 2, KIND_UNREADABLE = 3, KIND_END = 4 };

// Per-image metadata, one int32 array (mirrored in data/native_loader.py).
constexpr int META_INTS = 256;
enum MetaField {
  M_KIND = 0, M_WIDTH, M_HEIGHT, M_NCOMP, M_MAX_H, M_MAX_V, M_OUT_W, M_OUT_H,
  M_SCALE, M_COLOR, M_RESTART, M_COEFS, M_SOF,
};
constexpr int COMP_BASE = 16, COMP_INTS = 80, COMP_QT = 16;
enum CompField { C_H = 0, C_V, C_S, C_K, C_BW, C_BH, C_OFF, C_DW, C_DH };

constexpr int kLook = 10;

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
  bool progressive = false;
  bool multi_scan = false;  // progressive, or sequential with a first scan short of a component
  Comp comp[4];
  uint16_t qt[4][64];  // natural order, as last defined
  bool qt_present[4] = {false, false, false, false};
  // each component's table, latched at its first scan (jdinput.c's
  // latch_quant_tables); zeros for a component no scan holds
  uint16_t latched[4][64] = {};
  bool is_latched[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  Scan scan;              // the scan whose header was read last
  size_t scan_start = 0;  // where its entropy-coded data starts
};

inline int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }

bool build_huff(const uint8_t* counts, const uint8_t* vals, int nvals, bool is_ac, Huff* h) {
  int huffsize[257];
  int huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) {
      if (p >= 256) return false;
      huffsize[p++] = l;
    }
  huffsize[p] = 0;
  if (p != nvals) return false;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1 << si)) return false;
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
      if (vals[i] > 15) return false;  // a DC category past 15 (libjpeg: bad table)
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
  h->present = true;
  return true;
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
  if (ns < 1 || ns > 4 || slen < 1 + 2 * ns + 3) return KIND_UNREADABLE;
  sc.ncomp = ns;
  for (int i = 0; i < ns; ++i) {
    int cid = s[1 + 2 * i], tables = s[2 + 2 * i];
    int ci = -1;
    for (int c = 0; c < h->ncomp; ++c)
      if (h->comp[c].id == cid) ci = c;
    if (ci < 0) return KIND_UNREADABLE;
    for (int j = 0; j < i; ++j)
      if (sc.comp[j] == ci) return KIND_UNREADABLE;
    sc.comp[i] = ci;
    h->comp[ci].td = tables >> 4;
    h->comp[ci].ta = tables & 15;
    if (h->comp[ci].td > 3 || h->comp[ci].ta > 3) return KIND_UNREADABLE;
  }
  sc.ss = s[1 + 2 * ns];
  sc.se = s[2 + 2 * ns];
  sc.ah = s[3 + 2 * ns] >> 4;
  sc.al = s[3 + 2 * ns] & 15;
  return KIND_BASELINE;
}

// Parse markers from *at (2 for the first call: past SOI) up to the next
// SOS, whose header goes into h->scan, with *at and h->scan_start at its
// entropy-coded data (skipped by the search for the next marker, which
// passes stuffed bytes and RSTn): returns KIND_BASELINE, or KIND_END at EOI
// or the end of the data after a scan, or the Kind that ends the file's
// route (another JPEG process, markers that do not parse).
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
    int len = seg_len(d, n, pos);
    if (len < 2 || pos + size_t(len) > n) return end;
    const uint8_t* s = d + pos + 2;
    int slen = len - 2;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2: {
        if (h->saw_sof || slen < 6) return KIND_UNREADABLE;
        h->saw_sof = true;
        h->sof = m;
        h->progressive = m == 0xC2;
        h->precision = s[0];
        h->height = (s[1] << 8) | s[2];
        h->width = (s[3] << 8) | s[4];
        h->ncomp = s[5];
        if (h->precision != 8) return KIND_OTHER_JPEG;
        if (h->ncomp != 1 && h->ncomp != 3) return KIND_OTHER_JPEG;
        if (slen < 6 + 3 * h->ncomp) return KIND_UNREADABLE;
        if (h->width <= 0 || h->height <= 0) return KIND_OTHER_JPEG;  // DNL
        h->max_h = h->max_v = 1;
        for (int c = 0; c < h->ncomp; ++c) {
          Comp& cp = h->comp[c];
          cp.id = s[6 + 3 * c];
          cp.h = s[7 + 3 * c] >> 4;
          cp.v = s[7 + 3 * c] & 15;
          cp.tq = s[8 + 3 * c];
          if (cp.h < 1 || cp.h > 2 || cp.v < 1 || cp.v > 2) return KIND_OTHER_JPEG;
          if (cp.tq > 3) return KIND_UNREADABLE;
          h->max_h = std::max(h->max_h, cp.h);
          h->max_v = std::max(h->max_v, cp.v);
        }
        break;
      }
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
      case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        // lossless, hierarchical, arithmetic: the frame's size for the caller
        if (h->saw_sof || slen < 5) return KIND_UNREADABLE;
        h->sof = m;
        h->precision = s[0];
        h->height = (s[1] << 8) | s[2];
        h->width = (s[3] << 8) | s[4];
        return KIND_OTHER_JPEG;
      case 0xC4: {  // DHT
        int q = 0;
        while (q < slen) {
          if (q + 17 > slen) return KIND_UNREADABLE;
          int tc = s[q] >> 4, th = s[q] & 15;
          if (tc > 1 || th > 3) return KIND_UNREADABLE;
          int nv = 0;
          for (int i = 0; i < 16; ++i) nv += s[q + 1 + i];
          if (nv > 256 || q + 17 + nv > slen) return KIND_UNREADABLE;
          if (!build_huff(s + q + 1, s + q + 17, nv, tc == 1, tc ? &h->ac[th] : &h->dc[th]))
            return KIND_UNREADABLE;
          q += 17 + nv;
        }
        break;
      }
      case 0xDB: {  // DQT
        int q = 0;
        while (q < slen) {
          int pq = s[q] >> 4, tq = s[q] & 15;
          if (tq > 3 || pq > 1) return KIND_UNREADABLE;
          int need = 1 + 64 * (pq + 1);
          if (q + need > slen) return KIND_UNREADABLE;
          for (int k = 0; k < 64; ++k)
            h->qt[tq][kNatural[k]] =
                pq ? uint16_t((s[q + 1 + 2 * k] << 8) | s[q + 2 + 2 * k]) : s[q + 1 + k];
          h->qt_present[tq] = true;
          q += need;
        }
        break;
      }
      case 0xDD:  // DRI
        if (slen < 2) return KIND_UNREADABLE;
        h->restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xE0:
        if (slen >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) h->jfif = true;
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
        *at = h->scan_start = pos + len;
        return KIND_BASELINE;
      }
      default:
        break;  // APPn, COM, DNL, ...: skipped by length
    }
    pos += len;
  }
}

// The scan in h->scan against the frame's process (jdhuff.c's and
// jdphuff.c's start_pass checks), its tables present; latches the
// quantisation table of each component at its first scan. Returns a Kind.
int check_scan(Header* h) {
  const Scan& sc = h->scan;
  int blocks = 0;
  for (int i = 0; i < sc.ncomp; ++i) {
    const int c = sc.comp[i];
    const Comp& cp = h->comp[c];
    blocks += cp.h * cp.v;
    if (!h->is_latched[c]) {
      if (!h->qt_present[cp.tq]) return KIND_UNREADABLE;
      std::memcpy(h->latched[c], h->qt[cp.tq], sizeof(h->latched[c]));
      h->is_latched[c] = true;
    }
  }
  if (sc.ncomp > 1 && blocks > 10) return KIND_UNREADABLE;  // libjpeg's D_MAX_BLOCKS_IN_MCU
  bool need_dc, need_ac;
  if (!h->progressive) {
    if (sc.ss != 0 || sc.se != 63 || sc.ah != 0 || sc.al != 0) return KIND_OTHER_JPEG;
    need_dc = need_ac = true;
  } else {
    bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ncomp != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13 || bad) return KIND_UNREADABLE;  // libjpeg: JERR_BAD_PROGRESSION
    need_dc = sc.ss == 0 && sc.ah == 0;
    need_ac = sc.ss > 0;
  }
  for (int i = 0; i < sc.ncomp; ++i) {
    const Comp& cp = h->comp[sc.comp[i]];
    if ((need_dc && !h->dc[cp.td].present) || (need_ac && !h->ac[cp.ta].present)) return KIND_UNREADABLE;
  }
  return KIND_BASELINE;
}

// Parse markers up to the first SOS and check it. Returns a Kind.
int parse_header(const uint8_t* d, size_t n, Header* h) {
  if (n >= 4 && ((d[0] == 'I' && d[1] == 'I' && d[2] == 42 && d[3] == 0) ||
                 (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 42)))
    return KIND_TIFF;
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return KIND_UNREADABLE;
  size_t pos = 2;
  int kind = read_markers(d, n, &pos, h);
  if (kind != KIND_BASELINE) return kind;
  if (h->ncomp == 3) {
    // libjpeg's colour-space guess (jdapimin.c default_decompress_parms):
    // RGB-coded files are another process here
    bool rgb;
    if (h->jfif) rgb = false;
    else if (h->adobe) rgb = h->adobe_transform == 0;
    else rgb = h->comp[0].id == 82 && h->comp[1].id == 71 && h->comp[2].id == 66;
    if (rgb) return KIND_OTHER_JPEG;
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
  meta[M_COLOR] = h.ncomp == 3 ? 1 : 0;
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

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
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
      buf = (buf << 8) | c;
      bits += 8;
    }
  }
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
  void restart() {
    buf = 0;
    bits = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) ++p;
    }
    while (p + 1 < end && p[0] == 0xFF && p[1] == 0xFF) ++p;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      marker = false;
    } else if (p + 1 >= end) {
      marker = true;
    }
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

// Walk a scan's MCUs from h.scan_start, calling block(i, by, bx) for each
// block (i its component's place in the scan) after each MCU's restart
// handling (reset() drops the predictions and the EOB run). A
// non-interleaved scan covers its component's own blocks; an interleaved
// one the MCU grid.
template <class Block, class Reset>
void walk_mcus(BitReader& br, const Header& h, Block block, Reset reset) {
  const Scan& sc = h.scan;
  int restarts_to_go = h.restart_interval;
  auto mcu_start = [&]() {
    if (h.restart_interval) {
      if (restarts_to_go == 0) {
        br.restart();
        reset();
        restarts_to_go = h.restart_interval;
      }
      --restarts_to_go;
    }
  };
  if (sc.ncomp == 1) {
    const int c = sc.comp[0];
    const Comp& cp = h.comp[c];
    const int bw = ceil_div(long(h.width) * cp.h, 8L * h.max_h), bh = ceil_div(long(h.height) * cp.v, 8L * h.max_v);
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        mcu_start();
        block(0, by, bx);
      }
  } else {
    const int mcux = ceil_div(h.width, 8 * h.max_h), mcuy = ceil_div(h.height, 8 * h.max_v);
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        mcu_start();
        for (int i = 0; i < sc.ncomp; ++i) {
          const Comp& cp = h.comp[sc.comp[i]];
          for (int v = 0; v < cp.v; ++v)
            for (int u = 0; u < cp.h; ++u) block(i, my * cp.v + v, mx * cp.h + u);
        }
      }
  }
}

// Entropy-decode a one-scan image into coef (meta's layout): a block kept
// whole straight into its place, any other into a scratch block, then its
// kept square out. Data that ends early decodes as zeros, as libjpeg does
// after its "premature end" warning.
void decode_scan(const uint8_t* d, size_t n, const Header& h, const int32_t* meta, int16_t* coef) {
  BitReader br;
  br.p = d + h.scan_start;
  br.end = d + n;
  Cut cut[3];
  int BW[3], KK[3];
  int16_t* base[3];
  for (int c = 0; c < h.ncomp; ++c) {
    const int32_t* m = meta + COMP_BASE + COMP_INTS * c;
    cut[c] = Cut(m[C_S]);
    KK[c] = m[C_K] * m[C_K];
    BW[c] = m[C_BW];
    base[c] = coef + m[C_OFF];
  }
  int pred[3] = {0, 0, 0};
  alignas(16) int16_t blk[64];
  walk_mcus(
      br, h,
      [&](int i, int by, int bx) {
        const int c = h.scan.comp[i];
        const Comp& cp = h.comp[c];
        int16_t* out = base[c] + (long(by) * BW[c] + bx) * KK[c];
        int16_t* dst = KK[c] == 64 ? out : blk;
        std::memset(dst, 0, sizeof(blk));
        sequential_block(br, h.dc[cp.td], h.ac[cp.ta], pred[c], dst);
        if (dst == blk) cut_block(blk, cut[c], out);
      },
      [&]() { pred[0] = pred[1] = pred[2] = 0; });
}

// Walk every scan of a multi-scan image, from the one in h->scan on: given
// full (each component's blocks_w x blocks_h blocks of 64 coefficients,
// natural order, zeroed) each scan is decoded into it; given nullptr only
// the markers are read. Returns KIND_BASELINE, or the Kind a later scan gives
// the file: a progressive one whose scans leave one of a component's AC
// coefficients 1..9 unfinished is KIND_OTHER_JPEG, as libjpeg smooths its
// blocks (jdcoefct.c's smoothing_ok).
int walk_scans(const uint8_t* d, size_t n, Header* h, int16_t* full) {
  int coef_bits[3][64];
  std::fill(&coef_bits[0][0], &coef_bits[0][0] + 3 * 64, -1);
  int16_t* base[3] = {full, full, full};
  int bw[3] = {0, 0, 0};
  for (int c = 0; c < h->ncomp; ++c) {
    bw[c] = blocks_w(*h, c);
    if (full != nullptr && c + 1 < h->ncomp) base[c + 1] = base[c] + long(bw[c]) * blocks_h(*h, c) * 64;
  }
  size_t pos = h->scan_start;
  while (true) {
    const Scan& sc = h->scan;
    for (int i = 0; i < sc.ncomp; ++i)
      for (int k = sc.ss; k <= sc.se; ++k) coef_bits[sc.comp[i]][k] = sc.al;
    if (full != nullptr) {
      BitReader br;
      br.p = d + h->scan_start;
      br.end = d + n;
      int pred[3] = {0, 0, 0};
      unsigned eobrun = 0;
      const Header& hh = *h;
      walk_mcus(
          br, hh,
          [&](int i, int by, int bx) {
            const int c = sc.comp[i];
            const Comp& cp = hh.comp[c];
            int16_t* blk = base[c] + (long(by) * bw[c] + bx) * 64;
            if (!hh.progressive) sequential_block(br, hh.dc[cp.td], hh.ac[cp.ta], pred[c], blk);
            else if (sc.ss == 0 && sc.ah == 0) dc_first(br, hh.dc[cp.td], sc.al, pred[c], blk);
            else if (sc.ss == 0) dc_refine(br, sc.al, blk);
            else if (sc.ah == 0) ac_first(br, hh.ac[cp.ta], sc, eobrun, blk);
            else ac_refine(br, hh.ac[cp.ta], sc, eobrun, blk);
          },
          [&]() {
            pred[0] = pred[1] = pred[2] = 0;
            eobrun = 0;
          });
    }
    int kind = read_markers(d, n, &pos, h);
    if (kind == KIND_END) break;
    if (kind == KIND_BASELINE) kind = check_scan(h);
    if (kind != KIND_BASELINE) return kind;
  }
  if (h->progressive)
    for (int c = 0; c < h->ncomp; ++c)
      for (int k = 1; k <= 9; ++k)
        if (coef_bits[c][k] != 0) return KIND_OTHER_JPEG;
  return KIND_BASELINE;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return false;
  }
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    return false;
  }
  out->resize(size_t(n));
  bool ok = n == 0 || fread(out->data(), 1, size_t(n), f) == size_t(n);
  fclose(f);
  return ok;
}

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
// or -2 if cap (int16 units) is too small for the coefficients.
int decode_bytes(const uint8_t* d, size_t n, int scale_n, int32_t* meta, int16_t* coef, long cap) {
  Header* h = new Header();
  int kind = parse_header(d, n, h);
  if (kind == KIND_BASELINE && h->multi_scan) kind = walk_scans(d, n, h, nullptr);
  if (kind == KIND_BASELINE && !fill_meta(*h, scale_n, meta)) kind = KIND_OTHER_JPEG;
  if (kind != KIND_BASELINE) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    if (kind == KIND_OTHER_JPEG) {
      meta[M_WIDTH] = h->width;
      meta[M_HEIGHT] = h->height;
      meta[M_SOF] = h->sof;
    }
  } else if (coef != nullptr) {
    if (cap < meta[M_COEFS]) {
      kind = -2;
    } else if (h->multi_scan) {
      kind = decode_multi_scan(d, n, meta, coef);
    } else {
      decode_scan(d, n, *h, meta, coef);
    }
  }
  meta[M_KIND] = kind;
  delete h;
  return kind;
}

// ---------------------------------------------------------------- loader

struct Record {
  int32_t meta[META_INTS];
  std::vector<int16_t> coef;
};

struct Loader {
  std::vector<std::string> paths;
  int scale_n = 8;
  size_t depth = 16;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Record*> done;
  size_t next_claim = 0, next_emit = 0;
  bool stopping = false;
  std::vector<std::thread> workers;

  void worker() {
    std::vector<uint8_t> data;
    while (true) {
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stopping || next_claim < next_emit + depth; });
        if (stopping || next_claim >= paths.size()) return;
        i = next_claim++;
      }
      Record* rec = new Record();
      int kind;
      if (!read_file(paths[i].c_str(), &data)) {
        std::memset(rec->meta, 0, sizeof(rec->meta));
        kind = rec->meta[M_KIND] = KIND_UNREADABLE;
      } else {
        kind = decode_bytes(data.data(), data.size(), scale_n, rec->meta, nullptr, 0);
        if (kind == KIND_BASELINE) {
          rec->coef.resize(size_t(rec->meta[M_COEFS]));
          kind = decode_bytes(data.data(), data.size(), scale_n, rec->meta, rec->coef.data(),
                              long(rec->coef.size()));
        }
      }
      std::lock_guard<std::mutex> lk(mu);
      done[i] = rec;
      cv_ready.notify_all();
    }
  }

  ~Loader() {
    for (auto& kv : done) delete kv.second;
  }
};

}  // namespace

extern "C" {

int aq_jpeg_meta_ints() { return META_INTS; }

// Classify one file and fill its metadata at scale_n/8, without decoding.
int aq_jpeg_probe(const char* path, int scale_n, int32_t* meta) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    return meta[M_KIND] = KIND_UNREADABLE;
  }
  return decode_bytes(data.data(), data.size(), scale_n, meta, nullptr, 0);
}

// Decode one file's coefficients into coef (cap int16 values). Returns the
// Kind (coefficients written only for KIND_BASELINE) or -2 if cap is short.
int aq_jpeg_decode(const char* path, int scale_n, int32_t* meta, int16_t* coef, long cap) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data)) {
    std::memset(meta, 0, sizeof(int32_t) * META_INTS);
    return meta[M_KIND] = KIND_UNREADABLE;
  }
  return decode_bytes(data.data(), data.size(), scale_n, meta, coef, cap);
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

// Copy the peeked file's coefficients into dst (cap int16 values; dst may
// be null to drop them) and move past it. Returns 0, -2 if cap is short
// (nothing popped), -1 if nothing was peeked.
int aq_jpeg_loader_pop(void* handle, int16_t* dst, long cap) {
  if (handle == nullptr) return -1;
  auto* l = static_cast<Loader*>(handle);
  Record* rec;
  {
    std::lock_guard<std::mutex> lk(l->mu);
    auto it = l->done.find(l->next_emit);
    if (it == l->done.end()) return -1;
    rec = it->second;
    if (dst != nullptr && long(rec->coef.size()) > cap) return -2;
    l->done.erase(it);
    l->next_emit++;
  }
  l->cv_space.notify_all();
  if (dst != nullptr && !rec->coef.empty())
    std::memcpy(dst, rec->coef.data(), rec->coef.size() * sizeof(int16_t));
  delete rec;
  return 0;
}

// The kind of file path_idx if a worker has read it and it is not yet
// popped, else -1: lets the caller start other decoders ahead.
int aq_jpeg_loader_kind(void* handle, int path_idx) {
  if (handle == nullptr || path_idx < 0) return -1;
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(l->mu);
  auto it = l->done.find(size_t(path_idx));
  return it == l->done.end() ? -1 : it->second->meta[M_KIND];
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
