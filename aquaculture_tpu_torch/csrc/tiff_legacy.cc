// NeXT, ThunderScan, PixarLog and SGILog strips and tiles as libtiff 4.5.0
// decodes them (tif_next.c, tif_thunder.c, tif_pixarlog.c, tif_luv.c) for
// its RGBA interface; see tiff_legacy.h. Floats are libtiff's, operation by
// operation: the library builds with -ffp-contract=off.

#include "tiff_legacy.h"

#include <algorithm>
#include <cmath>
#include <cstring>

#include "tiff_decode.h"

namespace aq {
namespace {

// ---------------------------------------------------------------- NeXT

// SETPIXEL: four 2-bit pixels a byte, the first in the high bits.
inline void next_pixel(uint8_t*& op, uint32_t& npixels, uint64_t& op_offset, uint32_t v) {
  switch (npixels++ & 3) {
    case 0: op[0] = uint8_t(v << 6); break;
    case 1: op[0] = uint8_t(op[0] | v << 4); break;
    case 2: op[0] = uint8_t(op[0] | v << 2); break;
    default:
      *op = uint8_t(*op | v);
      ++op;
      ++op_offset;
      break;
  }
}

// ---------------------------------------------------------------- ThunderScan

const int kTwoBitDeltas[4] = {0, 1, 0, -1};
const int kThreeBitDeltas[8] = {0, 1, 2, 3, 0, -3, -2, -1};

// ThunderDecode: one row of maxpixels 4-bit pixels; false unless exactly
// maxpixels came out. *bp and *cc move on as libtiff's raw pointer does.
bool thunder_row(const uint8_t** bpp, size_t* ccp, uint8_t* op, int64_t maxpixels) {
  const uint8_t* bp = *bpp;
  size_t cc = *ccp;
  unsigned lastpixel = 0;
  int64_t npixels = 0;
  auto setvalue = [&](unsigned v) {
    lastpixel = v & 0xf;
    if (npixels < maxpixels) {
      if (npixels++ & 1) *op++ |= uint8_t(lastpixel);
      else op[0] = uint8_t(lastpixel << 4);
    }
  };
  while (cc > 0 && npixels < maxpixels) {
    int n = *bp++;
    cc--;
    int delta;
    switch (n & 0xc0) {
      case 0x00:  // a run of the last pixel, n's low 6 bits long
        if (npixels & 1) {
          op[0] = uint8_t(op[0] | lastpixel);
          lastpixel = *op++;
          npixels++;
          n--;
        } else {
          lastpixel |= lastpixel << 4;
        }
        npixels += n;
        if (npixels < maxpixels)
          for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
        if (n == -1) *--op &= 0xf0;
        lastpixel &= 0xf;
        break;
      case 0x40:  // three 2-bit deltas, 2 skipping
        if ((delta = (n >> 4) & 3) != 2) setvalue(unsigned(int(lastpixel) + kTwoBitDeltas[delta]));
        if ((delta = (n >> 2) & 3) != 2) setvalue(unsigned(int(lastpixel) + kTwoBitDeltas[delta]));
        if ((delta = n & 3) != 2) setvalue(unsigned(int(lastpixel) + kTwoBitDeltas[delta]));
        break;
      case 0x80:  // two 3-bit deltas, 4 skipping
        if ((delta = (n >> 3) & 7) != 4) setvalue(unsigned(int(lastpixel) + kThreeBitDeltas[delta]));
        if ((delta = n & 7) != 4) setvalue(unsigned(int(lastpixel) + kThreeBitDeltas[delta]));
        break;
      default:  // a raw pixel
        setvalue(unsigned(n));
        break;
    }
  }
  *bpp = bp;
  *ccp = cc;
  return npixels == maxpixels;
}

// ---------------------------------------------------------------- PixarLog

constexpr int kPixarTable = 2049;  // TSIZEP1
constexpr unsigned kCodeMask = 0x7ff;

// PixarLogMakeTables: ToLinearF in float, then ToLinear16 and ToLinear8
// rounded from it in double.
struct PixarTables {
  uint16_t to16[kPixarTable];
  uint8_t to8[kPixarTable];
};

const PixarTables& pixar_tables() {
  static const PixarTables tables = [] {
    PixarTables t;
    float to_f[kPixarTable];
    double c = std::log(1.004);  // RATIO
    const int nlin = int(1. / c);
    c = 1. / nlin;
    const double b = std::exp(-c * 1250);  // ONE
    const double linstep = b * c * std::exp(1.);
    int j = 0;
    for (int i = 0; i < nlin; i++) to_f[j++] = float(i * linstep);
    for (int i = nlin; i < 2048; i++) to_f[j++] = float(b * std::exp(c * i));
    to_f[2048] = to_f[2047];
    for (int i = 0; i < kPixarTable; i++) {
      double v = to_f[i] * 65535.0 + 0.5;
      t.to16[i] = v > 65535.0 ? 65535 : uint16_t(v);
      v = to_f[i] * 255.0 + 0.5;
      t.to8[i] = v > 255.0 ? 255 : uint8_t(v);
    }
    return t;
  }();
  return tables;
}

// horizontalAccumulate8 / horizontalAccumulate16 over one row of n words.
// Strides 3 and 4 keep running sums; any other stride adds each word into
// the one a pixel on (wp[stride] += *wp) and maps the word it stands on, as
// libtiff's loop does, reaching stride words past the row.
template <typename T>
void accumulate(uint16_t* wp, int n, int stride, T* op, const T* table) {
  if (n < stride) return;
  if (stride == 3 || stride == 4) {
    unsigned acc[4];
    for (int k = 0; k < stride; ++k) op[k] = table[acc[k] = (wp[k] & kCodeMask)];
    n -= stride;
    while (n > 0) {
      wp += stride;
      op += stride;
      n -= stride;
      for (int k = 0; k < stride; ++k) op[k] = table[(acc[k] += wp[k]) & kCodeMask];
    }
    return;
  }
  for (int i = stride; i > 0; --i, ++wp, ++op) *op = table[*wp & kCodeMask];
  n -= stride;
  while (n > 0) {
    for (int i = stride; i > 0; --i, ++wp, ++op) {
      wp[stride] = uint16_t(wp[stride] + *wp);
      *op = table[*wp & kCodeMask];
    }
    n -= stride;
  }
}

// ---------------------------------------------------------------- SGILog

constexpr double kLn2 = 0.69314718055994530942;  // M_LN2
constexpr double kUvScale = 410.;                // UVSCALE
constexpr double kUNeu = 0.210526316, kVNeu = 0.473684211;
constexpr float kUvSqSiz = 0.003500f, kUvVStart = 0.016940f;  // uvcode.h
constexpr int kUvNvs = 163, kUvNdivs = 16289;

// uvcode.h's uv_row: each row of the (u', v') grid, its first u' and the
// cells before it.
const struct {
  float ustart;
  int16_t nus, ncum;
} kUvRow[kUvNvs] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17}, {0.235906f, 10, 26},
    {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62}, {0.222371f, 17, 77}, {0.220410f, 18, 94},
    {0.214710f, 21, 112}, {0.212714f, 22, 133}, {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204},
    {0.199245f, 29, 231}, {0.195525f, 31, 260}, {0.193560f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507}, {0.172001f, 44, 549},
    {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683}, {0.163575f, 49, 729}, {0.158642f, 52, 778},
    {0.158642f, 52, 830}, {0.158642f, 52, 882}, {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044},
    {0.149097f, 58, 1102}, {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.138270f, 65, 1346},
    {0.138270f, 65, 1411}, {0.138270f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610}, {0.126204f, 73, 1679},
    {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898}, {0.120381f, 77, 1975}, {0.120381f, 77, 2052},
    {0.120381f, 77, 2129}, {0.112962f, 82, 2206}, {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.107450f, 86, 2452},
    {0.107450f, 86, 2538}, {0.107450f, 86, 2624}, {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259}, {0.095126f, 95, 3354},
    {0.088276f, 100, 3449}, {0.088276f, 100, 3549}, {0.088276f, 100, 3649}, {0.088276f, 100, 3749}, {0.081523f, 105, 3849},
    {0.081523f, 105, 3954}, {0.081523f, 105, 4059}, {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379},
    {0.074861f, 110, 4489}, {0.074861f, 110, 4599}, {0.068290f, 115, 4709}, {0.068290f, 115, 4824}, {0.068290f, 115, 4939},
    {0.068290f, 115, 5054}, {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407}, {0.063573f, 119, 5526},
    {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893}, {0.057219f, 124, 6017}, {0.050985f, 129, 6141},
    {0.050985f, 129, 6270}, {0.050985f, 129, 6399}, {0.050985f, 129, 6528}, {0.050985f, 129, 6657}, {0.044859f, 134, 6786},
    {0.044859f, 134, 6920}, {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874}, {0.036339f, 142, 8016}, {0.036339f, 142, 8158},
    {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588}, {0.032139f, 146, 8734}, {0.032139f, 146, 8880},
    {0.027947f, 150, 9026}, {0.027947f, 150, 9176}, {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630},
    {0.023739f, 154, 9784}, {0.023739f, 154, 9938}, {0.019504f, 158, 10092}, {0.019504f, 158, 10250}, {0.019504f, 158, 10408},
    {0.016976f, 161, 10566}, {0.016976f, 161, 10727}, {0.016976f, 161, 10888}, {0.016976f, 161, 11049}, {0.012639f, 165, 11210},
    {0.012639f, 165, 11375}, {0.012639f, 165, 11540}, {0.009991f, 168, 11705}, {0.009991f, 168, 11873}, {0.009991f, 168, 12041},
    {0.009016f, 170, 12209}, {0.009016f, 170, 12379}, {0.009016f, 170, 12549}, {0.006217f, 173, 12719}, {0.006217f, 173, 12892},
    {0.005097f, 175, 13065}, {0.005097f, 175, 13240}, {0.005097f, 175, 13415}, {0.003909f, 177, 13590}, {0.003909f, 177, 13767},
    {0.002340f, 177, 13944}, {0.002389f, 170, 14121}, {0.001068f, 164, 14291}, {0.001653f, 157, 14455}, {0.000717f, 150, 14612},
    {0.001614f, 143, 14762}, {0.000270f, 136, 14905}, {0.000484f, 129, 15041}, {0.001103f, 123, 15170}, {0.001242f, 115, 15293},
    {0.001188f, 109, 15408}, {0.001011f, 103, 15517}, {0.000709f, 97, 15620}, {0.000301f, 89, 15717}, {0.002416f, 82, 15806},
    {0.003251f, 76, 15888}, {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.010490f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268},
};

double logl16_to_y(int p16) {  // LogL16toY
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {  // LogL10toY
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

int uv_decode(double* up, double* vp, int c) {  // the binary search over uv_row
  if (c < 0 || c >= kUvNdivs) return -1;
  int lower = 0, upper = kUvNvs;
  while (upper - lower > 1) {
    const int vi = (lower + upper) >> 1;
    const int ui = c - kUvRow[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  const int vi = lower, ui = c - kUvRow[vi].ncum;
  *up = kUvRow[vi].ustart + (ui + .5) * kUvSqSiz;
  *vp = kUvVStart + (vi + .5) * kUvSqSiz;
  return 0;
}

void uv_to_xyz(double u, double v, double l, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = float(x / y * l);
  xyz[1] = float(l);
  xyz[2] = float((1. - x - y) / y * l);
}

void logluv32_to_xyz(uint32_t p, float* xyz) {  // LogLuv32toXYZ
  const double l = logl16_to_y(int32_t(p) >> 16);
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  uv_to_xyz(1. / kUvScale * ((p >> 8 & 0xff) + .5), 1. / kUvScale * ((p & 0xff) + .5), l, xyz);
}

void logluv24_to_xyz(uint32_t p, float* xyz) {  // LogLuv24toXYZ
  const double l = logl10_to_y(int(p >> 14 & 0x3ff));
  if (l <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u, v;
  if (uv_decode(&u, &v, int(p & 0x3fff)) < 0) {
    u = kUNeu;
    v = kVNeu;
  }
  uv_to_xyz(u, v, l, xyz);
}

inline uint8_t gamma2(double c) { return uint8_t(c <= 0. ? 0 : c >= 1. ? 255 : int(256. * std::sqrt(c))); }

void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {  // XYZtoRGB24: CCIR-709 primaries, gamma 2
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma2(r);
  rgb[1] = gamma2(g);
  rgb[2] = gamma2(b);
}

// LogL16Decode and LogLuvDecode32: byte planes, most significant first,
// each of runs (a count byte of 128 + n - 2, then the byte) and literals (a
// count byte, then that many bytes) ORed into the row's words. Returns
// whether every plane filled the row; *bp and *cc move on either way.
template <typename W, int Planes>
bool sgilog_planes(const uint8_t** bpp, size_t* ccp, W* tp, int64_t npixels) {
  std::fill(tp, tp + npixels, W(0));
  const uint8_t* bp = *bpp;
  int64_t cc = int64_t(*ccp);
  bool ok = true;
  for (int shft = 8 * (Planes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npixels && cc > 0) {
      if (*bp >= 128) {  // a run
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        const W b = W(W(*bp++) << shft);
        cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {  // literals (a count of 0 does nothing)
        int rc = *bp++;
        while (--cc && rc-- && i < npixels) tp[i++] |= W(W(*bp++) << shft);
      }
    }
    if (i != npixels) {
      ok = false;
      break;
    }
  }
  *bpp = bp;
  *ccp = size_t(cc);
  return ok;
}

}  // namespace

bool next_decode(const uint8_t* bp, size_t cc, uint8_t* buf, uint64_t occ, uint64_t scanline, uint32_t width) {
  std::memset(buf, 0xff, size_t(occ));  // each row starts white
  if (scanline == 0 || occ % scanline) return false;  // "Fractional scanlines cannot be read"
  for (uint8_t* row = buf; cc > 0 && occ > 0; occ -= scanline, row += scanline) {
    int n = *bp++;
    cc--;
    if (n == 0x00) {  // LITERALROW
      if (cc < scanline) return false;
      std::memcpy(row, bp, size_t(scanline));
      bp += scanline;
      cc -= size_t(scanline);
    } else if (n == 0x40) {  // LITERALSPAN: a 16-bit offset and length, big-endian
      if (cc < 4) return false;
      const uint64_t off = uint64_t(bp[0]) * 256 + bp[1], len = uint64_t(bp[2]) * 256 + bp[3];
      if (cc < 4 + len || off + len > scanline) return false;
      std::memcpy(row + off, bp + 4, size_t(len));
      bp += 4 + len;
      cc -= size_t(4 + len);
    } else {  // runs: <grey:2><count:6> bytes until the row is full
      uint32_t npixels = 0;
      uint64_t op_offset = 0;
      uint8_t* op = row;
      for (;;) {
        const uint32_t grey = uint32_t(n >> 6) & 0x3;
        n &= 0x3f;
        while (n-- > 0 && npixels < width && op_offset < scanline) next_pixel(op, npixels, op_offset, grey);
        if (npixels >= width) break;
        if (op_offset >= scanline) return false;  // "Invalid data for scanline"
        if (cc == 0) return false;
        n = *bp++;
        cc--;
      }
    }
  }
  return true;
}

bool thunder_decode(const uint8_t* bp, size_t cc, uint8_t* row, uint64_t occ, uint64_t scanline, uint32_t width) {
  if (scanline == 0 || occ % scanline) return false;  // "Fractional scanlines cannot be read"
  for (; occ > 0; occ -= scanline, row += scanline)
    if (!thunder_row(&bp, &cc, row, int64_t(width))) return false;
  return true;
}

bool pixarlog_decode(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, const PixarLogShape& shape,
                     std::vector<uint16_t>* tbuf) {
  int64_t nsamples = int64_t(shape.sixteen ? occ / 2 : occ);
  const int llen = shape.stride * int(shape.width);
  const uint64_t bytes = uint64_t(nsamples) * 2;
  if (bytes > 0xFFFFFFFFu || bytes > shape.tbuf_size) return false;  // avail_out past uInt or the buffer
  tbuf->resize(size_t(nsamples) + 2 * size_t(shape.stride));  // the words, and a pixel past them for the loop
  uint16_t* up = tbuf->data();
  if (!inflate_zlib(src, cc, reinterpret_cast<uint8_t*>(up), size_t(bytes), INFLATE_ZLIB)) return false;
  if (shape.swab)
    for (int64_t i = 0; i < nsamples; ++i) up[i] = uint16_t(up[i] >> 8 | up[i] << 8);
  if (llen <= 0) return true;
  nsamples -= nsamples % llen;  // a row cut short is left out
  const PixarTables& t = pixar_tables();
  for (int64_t i = 0; i < nsamples; i += llen, up += llen) {
    if (shape.sixteen) accumulate(up, llen, shape.stride, reinterpret_cast<uint16_t*>(out) + i, t.to16);
    else accumulate(up, llen, shape.stride, out + i, t.to8);
  }
  return true;
}

bool sgilog_decode(const uint8_t* bp, size_t cc, uint8_t* out, uint64_t occ, uint64_t rowlen, int kind,
                   uint64_t tbuflen) {
  if (rowlen == 0) return false;
  const int64_t npixels = int64_t(rowlen / (kind == SGILOG_L16 ? 1 : 3));
  std::vector<uint32_t> luv;
  std::vector<int16_t> l16;
  for (; occ > 0; occ -= rowlen, out += rowlen) {
    if (uint64_t(npixels) > tbuflen) return false;  // "Translation buffer too short"
    if (kind == SGILOG_L16) {
      l16.resize(size_t(npixels));
      if (!sgilog_planes<int16_t, 2>(&bp, &cc, l16.data(), npixels)) return false;
      for (int64_t i = 0; i < npixels; ++i) out[i] = gamma2(logl16_to_y(l16[size_t(i)]));  // L16toGry
      continue;
    }
    luv.resize(size_t(npixels));
    if (kind == SGILOG_LUV32) {
      if (!sgilog_planes<uint32_t, 4>(&bp, &cc, luv.data(), npixels)) return false;
    } else {  // LogLuvDecode24: three bytes a pixel, big-endian
      int64_t i = 0;
      for (; i < npixels && cc >= 3; i++, bp += 3, cc -= 3) luv[size_t(i)] = uint32_t(bp[0]) << 16 | bp[1] << 8 | bp[2];
      if (i != npixels) return false;
    }
    float xyz[3];
    for (int64_t i = 0; i < npixels; ++i) {
      if (kind == SGILOG_LUV32) logluv32_to_xyz(luv[size_t(i)], xyz);
      else logluv24_to_xyz(luv[size_t(i)], xyz);
      xyz_to_rgb24(xyz, out + 3 * i);
    }
  }
  return true;
}

}  // namespace aq
