// jbigkit 2.1's decoder (jbig.c: jbg_newlen, jbg_dec_in, decode_pscd;
// jbig_ar.c: arith_decode) as tif_jbig.c 4.5.0 drives it, for BIEs of one
// resolution layer (D = 0) and one plane; see jbig_decode.h. The QM coder's
// probability estimation is T.82 Table 24, which is T.81 Table D.2: the
// table jpeg_entropy.cc's arithmetic decoder reads (kAriTab).

#include "jbig_decode.h"

#include <cstring>
#include <vector>

#include "tiff_decode.h"

namespace aq {
namespace {

enum Marker : uint8_t {
  MARKER_ESC = 0xff, MARKER_STUFF = 0x00, MARKER_SDNORM = 0x02, MARKER_SDRST = 0x03, MARKER_ABORT = 0x04,
  MARKER_NEWLEN = 0x05, MARKER_ATMOVE = 0x06, MARKER_COMMENT = 0x07,
};
enum Option { LRLTWO = 0x40, VLENGTH = 0x20, DPON = 0x04, DPPRIV = 0x02, DPLAST = 0x01, TPBON = 0x08 };
constexpr int kAtMovesMax = 64;        // JBG_ATMOVES_MAX
constexpr int kTpb2Cx = 0x195, kTpb3Cx = 0x0e5;  // TPB2CX, TPB3CX
constexpr int kDpTableBytes = 1728;

// iindex[order & 7][0] < 0: the SMID-only and SMID + ILEAVE + SEQ orders
// that jbg_dec_in refuses.
inline bool order_refused(int order) { return (order & 7) == 1 || (order & 7) == 7; }

inline unsigned long ceil_half(unsigned long x, int n) {  // jbg_ceil_half
  const unsigned long mask = (1UL << n) - 1;
  return (x >> n) + ((mask & x) != 0);
}

inline unsigned long be32(const uint8_t* p) {
  return (unsigned long)p[0] << 24 | (unsigned long)p[1] << 16 | (unsigned long)p[2] << 8 | p[3];
}

// jbg_dec_in's tests of the 20-byte BIH of a BIE read from the start.
bool bih_ok(const uint8_t* b) {
  if (b[1] < b[0] || b[3] != 0 || (b[18] & 0xf0) != 0 || (b[19] & 0x80) != 0) return false;  // JBG_EINVAL 1-4
  if (b[0] != 0) return false;                                                           // JBG_ENOCONT
  if (b[2] == 0 || be32(b + 4) == 0 || be32(b + 8) == 0 || be32(b + 12) == 0) return false;  // 5-8
  if (b[1] > 31 || (b[1] != 0 && be32(b + 12) >= (1UL << (32 - b[1])))) return false;    // JBG_EIMPL
  if (b[16] > 127 || order_refused(b[18])) return false;                                  // 9, 10
  return true;
}

void reverse_bits(uint8_t* p, size_t n) {  // TIFFReverseBits
  for (size_t i = 0; i < n; ++i) p[i] = uint8_t((p[i] * 0x0202020202ULL & 0x010884422010ULL) % 1023);
}

// jbg_next_pscdend: from the start of a PSCD or marker segment to the start
// of the next one (end where none follows), or null where the segment is
// incomplete, unterminated or unknown.
const uint8_t* next_pscdend(const uint8_t* p, size_t len) {
  if (len < 2) return nullptr;
  if (p[0] != MARKER_ESC || p[1] == MARKER_STUFF) {
    do {
      while (p[0] == MARKER_ESC && p[1] == MARKER_STUFF) {
        p += 2;
        len -= 2;
        if (len < 2) return nullptr;
      }
      const uint8_t* pp = static_cast<const uint8_t*>(std::memchr(p, MARKER_ESC, len - 1));
      if (!pp) return nullptr;
      const size_t l = size_t(pp - p);
      p += l;
      len -= l;
    } while (p[1] == MARKER_STUFF);
    return p;
  }
  switch (p[1]) {
    case MARKER_SDNORM: case MARKER_SDRST: case MARKER_ABORT: return p + 2;
    case MARKER_NEWLEN: return len < 6 ? nullptr : p + 6;
    case MARKER_ATMOVE: return len < 8 ? nullptr : p + 8;
    case MARKER_COMMENT: {
      if (len < 6) return nullptr;
      const unsigned long l = be32(p + 2);
      return len - 6 < l ? nullptr : p + 6 + l;
    }
    default: return nullptr;
  }
}

// jbg_newlen: a NEWLEN marker's YD written into the BIH, where the scan
// reaches one before an ABORT, an end or a segment it cannot pass.
void newlen(uint8_t* bie, size_t len) {
  if (len < 20) return;
  const uint8_t* p = bie + 20;
  if ((bie[19] & (DPON | DPPRIV | DPLAST)) == (DPON | DPPRIV)) p += kDpTableBytes;
  if (p >= bie + len) return;
  while ((p = next_pscdend(p, len - size_t(p - bie)))) {
    if (p == bie + len) return;
    if (p[0] != MARKER_ESC) continue;
    if (p[1] == MARKER_NEWLEN) {
      if (p + 5 >= bie + len) return;
      if (be32(p + 2) > be32(bie + 8)) return;
      std::memcpy(bie + 8, p + 2, 4);
      return;
    }
    if (p[1] == MARKER_ABORT) return;
  }
}

// jbig_ar.c's decoder state and arith_decode.
struct ArDec {
  uint8_t st[4096];
  unsigned long c = 0, a = 1;
  const uint8_t* ptr = nullptr;
  const uint8_t* end = nullptr;
  int ct = 0;
  bool startup = true;

  void init(bool reuse_st) {  // arith_decode_init
    if (!reuse_st) std::memset(st, 0, sizeof(st));
    c = 0;
    a = 1;
    ct = 0;
    startup = true;
  }

  // 0 or 1; -1 where the PSCD ends (or ends in an 0xff) before the symbol.
  int decode(int cx) {
    while (a < 0x8000 || startup) {
      while (ct <= 8 && ct >= 0) {
        if (ptr >= end) return -1;
        if (*ptr == 0xff) {
          if (ptr + 1 >= end) return -1;
          if (ptr[1] == MARKER_STUFF) {
            c |= 0xffUL << (8 - ct);
            ct += 8;
            ptr += 2;
          } else {
            ct = -1;  // a marker: zeros from here on
          }
        } else {
          c |= (unsigned long)*ptr++ << (8 - ct);
          ct += 8;
        }
      }
      c <<= 1;
      a <<= 1;
      if (ct >= 0) ct--;
      if (a == 0x10000UL) startup = false;
    }
    uint8_t* s = st + cx;
    const int ss = *s & 0x7f;
    const int32_t e = kAriTab[ss];
    const unsigned lsz = unsigned(e >> 16), nmps = unsigned(e >> 8) & 0x7f, nlps = unsigned(e) & 0xff;
    int pix;
    if ((c >> 16) < (a -= lsz)) {
      if (a & 0xffff8000UL) return *s >> 7;
      if (a < lsz) {  // MPS_EXCHANGE
        pix = 1 - (*s >> 7);
        *s = uint8_t((*s & 0x80) ^ nlps);
      } else {
        pix = *s >> 7;
        *s = uint8_t((*s & 0x80) | nmps);
      }
    } else {  // LPS_EXCHANGE
      c -= a << 16;
      if (a < lsz) {
        a = lsz;
        pix = *s >> 7;
        *s = uint8_t((*s & 0x80) | nmps);
      } else {
        a = lsz;
        pix = 1 - (*s >> 7);
        *s = uint8_t((*s & 0x80) ^ nlps);
      }
    }
    return pix;
  }
};

// jbg_dec_state for one layer and one plane.
struct Decoder {
  unsigned long xd = 0, yd = 0, l0 = 0, stripes = 0, stripe = 0;
  int options = 0, mx = 0, my = 0;
  std::vector<uint8_t> image;  // lhp[0][0]: yd rows of ceil(xd / 8) bytes
  int tx = 0, lntp = 1;
  bool reset = false;  // the stripe before ended with SDRST
  ArDec s;
  uint8_t buffer[20];
  int buf_len = 0;
  unsigned long comment_skip = 0, x = 0, i = 0;
  int at_moves = 0;
  unsigned long at_line[kAtMovesMax];
  int at_tx[kAtMovesMax];
  unsigned long line_h1 = 0, line_h2 = 0, line_h3 = 0;
  bool pseudo = true;

  // decode_pscd at layer 0: the pixels of the current stripe that the len
  // bytes at data give; returns the bytes it read.
  size_t pscd(const uint8_t* data, size_t len) {
    s.ptr = data;
    s.end = data + len;
    const unsigned long hl = l0, hx = xd, hy = yd, hbpl = ceil_half(xd, 3);
    unsigned long y = stripe * hl + i;
    uint8_t* hp = image.data() + (stripe * hl + i) * hbpl + (x >> 3);
    unsigned long h1 = line_h1, h2 = line_h2, h3 = line_h3;
    if (x == 0 && i == 0 && (stripe == 0 || reset) && pseudo) {
      tx = 0;
      lntp = 1;
    }
    for (; i < hl && y < hy; i++, y++) {
      if (x == 0 && pseudo)  // adaptive template changes
        for (int n = 0; n < at_moves; n++)
          if (at_line[n] == i) tx = at_tx[n];
      if ((options & TPBON) && pseudo) {  // typical prediction
        const int slntp = s.decode((options & LRLTWO) ? kTpb2Cx : kTpb3Cx);
        if (slntp < 0) goto leave;
        lntp = !(slntp ^ lntp);
        if (!lntp) {  // a line like the one before (white at the top)
          if (i == 0 && (stripe == 0 || reset)) std::memset(hp, 0, hbpl);
          else std::memmove(hp, hp - hbpl, hbpl);
          hp += hbpl;
          continue;
        }
      }
      pseudo = false;
      // bits of the pixels before X in h1, of the lines above in h2 and h3
      // (the pixel above X at bit 15)
      if (x == 0) {
        h1 = h2 = h3 = 0;
        if (i > 0 || (y > 0 && !reset)) h2 = (unsigned long)*(hp - hbpl) << 8;
        if (i > 1 || (y > 1 && !reset)) h3 = (unsigned long)*(hp - hbpl - hbpl) << 8;
      }
      while (x < hx) {
        if ((x & 7) == 0 && x < hbpl * 8 - 8 && (i > 0 || (y > 0 && !reset))) {
          h2 |= *(hp - hbpl + 1);
          if (i > 1 || (y > 1 && !reset)) h3 |= *(hp - hbpl - hbpl + 1);
        }
        const unsigned t = unsigned(tx);
        do {
          unsigned long a = 0;  // the AT pixel
          if (tx) {
            if (t <= x) {
              if (tx < 8) {  // in h1 (a shift past it wraps as the x86 shift does)
                a = (options & LRLTWO) ? (h1 >> ((tx - 5) & 63)) & 0x010 : (h1 >> ((tx - 3) & 63)) & 0x004;
              } else {
                const long o = long(x - t) - long(x & ~7UL);
                a = (unsigned long)(hp[o >> 3] >> (7 - (o & 7))) & 1;
                a <<= (options & LRLTWO) ? 4 : 2;
              }
            }
          }
          int pix;
          if (options & LRLTWO)  // the two-line template
            pix = s.decode(int(((h2 >> 9) & (tx ? 0x3e0 : 0x3f0)) | a | (h1 & 0x00f)));
          else  // the three-line template
            pix = s.decode(int(((h3 >> 7) & 0x380) | ((h2 >> 11) & (tx ? 0x078 : 0x07c)) | a | (h1 & 0x003)));
          if (pix < 0) goto leave;
          h1 = (h1 << 1) | unsigned(pix);
          h2 <<= 1;
          h3 <<= 1;
        } while ((++x & 7) && x < hx);
        *hp++ = uint8_t(h1);
      }
      *(hp - 1) = uint8_t(*(hp - 1) << (hbpl * 8 - hx));
      x = 0;
      pseudo = true;
    }
  leave:
    line_h1 = h1;
    line_h2 = h2;
    line_h3 = h3;
    return size_t(s.ptr - data);
  }
};

}  // namespace

bool jbig_layered(const uint8_t* raw, size_t n, bool reverse) {
  if (n < 20) return false;
  uint8_t b[20];
  std::memcpy(b, raw, 20);
  if (reverse) reverse_bits(b, 20);
  return bih_ok(b) && (b[1] != 0 || b[2] != 1);
}

bool jbig_decode(const uint8_t* raw, size_t n, bool reverse, uint8_t* out, uint64_t occ) {
  std::vector<uint8_t> bie(raw, raw + n);
  if (reverse) reverse_bits(bie.data(), n);
  newlen(bie.data(), n);
  const uint8_t* data = bie.data();
  if (n < 20 || !bih_ok(data) || data[1] != 0 || data[2] != 1) return false;
  Decoder d;
  d.xd = be32(data + 4);
  d.yd = be32(data + 8);
  d.l0 = be32(data + 12);
  d.mx = data[16];
  d.my = data[17];
  d.options = data[19];
  d.stripes = d.yd / d.l0 + (d.yd % d.l0 != 0);  // jbg_stripes at D = 0
  const unsigned long hbpl = ceil_half(d.xd, 3);
  if (hbpl > (1UL << 31) / d.yd) return false;  // past anything a strip holds
  d.image.assign(size_t(hbpl * d.yd), 0);
  d.s.init(false);
  size_t cnt = 20;
  if ((d.options & (DPON | DPPRIV | DPLAST)) == (DPON | DPPRIV)) {  // a private DPTABLE, unused at D = 0
    if (n - cnt < size_t(kDpTableBytes)) return false;
    cnt += kDpTableBytes;
  }
  while (cnt < n) {
    if (d.comment_skip) {  // a COMMENT's contents
      if (d.comment_skip <= n - cnt) {
        cnt += d.comment_skip;
        d.comment_skip = 0;
      } else {
        return false;
      }
      continue;
    }
    if (d.buf_len > 0) {  // a marker segment, read whole into buffer
      while (d.buf_len < 2 && cnt < n) d.buffer[d.buf_len++] = data[cnt++];
      if (d.buf_len < 2) continue;
      int need;
      switch (d.buffer[1]) {
        case MARKER_COMMENT: need = 6; break;
        case MARKER_ATMOVE: need = 8; break;
        case MARKER_NEWLEN: need = 6; break;
        case MARKER_ABORT: case MARKER_SDNORM: case MARKER_SDRST: need = 2; break;
        case MARKER_STUFF:  // a stuffed 0xff for the arithmetic decoder
          d.buf_len = 0;
          d.pscd(d.buffer, 2);
          continue;
        default: return false;  // JBG_EMARKER
      }
      while (d.buf_len < need && cnt < n) d.buffer[d.buf_len++] = data[cnt++];
      if (d.buf_len < need) continue;
      switch (d.buffer[1]) {
        case MARKER_COMMENT:
          d.comment_skip = be32(d.buffer + 2);
          break;
        case MARKER_ATMOVE: {
          if (d.at_moves >= kAtMovesMax) return false;
          const int atx = int8_t(d.buffer[6]), aty = d.buffer[7];
          if (atx < -d.mx || atx > d.mx || aty > d.my || (aty == 0 && atx < 0)) return false;
          if (aty != 0) return false;  // JBG_EIMPL
          d.at_line[d.at_moves] = be32(d.buffer + 2);
          d.at_tx[d.at_moves++] = atx;
          break;
        }
        case MARKER_NEWLEN: {
          const unsigned long y = be32(d.buffer + 2);
          if (y > d.yd || !(d.options & VLENGTH)) return false;
          d.yd = y;
          d.stripes = d.yd / d.l0 + (d.yd % d.l0 != 0);
          break;
        }
        case MARKER_ABORT:
          return false;
        default: {  // SDNORM, SDRST: the stripe's last pixels from zero padding
          d.pscd(d.buffer, 2);
          const bool rst = d.buffer[1] == MARKER_SDRST;
          d.s.init(d.stripe != d.stripes - 1 && !rst);
          d.reset = rst;
          d.x = 0;
          d.i = 0;
          d.pseudo = true;
          d.at_moves = 0;
          d.buf_len = 0;
          if (++d.stripe > d.stripes - 1) {  // the final SDE: jbg_dec_getsize's bytes to libtiff
            const uint64_t size = uint64_t(hbpl) * d.yd;
            if (size > occ) return false;
            std::memcpy(out, d.image.data(), size_t(size));
            return true;
          }
          break;
        }
      }
      d.buf_len = 0;
    } else if (data[cnt] == MARKER_ESC) {
      d.buffer[d.buf_len++] = data[cnt++];
    } else {  // PSCD bytes
      cnt += d.pscd(data + cnt, n - cnt);
      if (cnt < n && data[cnt] != MARKER_ESC) return false;  // the PSCD runs past the stripe
    }
  }
  return false;  // JBG_EAGAIN: the BIE ends early
}

}  // namespace aq
