// What csrc/jpeg_entropy.cc and csrc/tiff_decode.cc share: they are built
// into one library (data/native_loader.py), whose loader threads read JPEG
// and TIFF files alike.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <vector>

namespace aq {

// A file's route (M_KIND). KIND_BASELINE: the entropy decoder takes the file.
enum Kind { KIND_BASELINE = 0, KIND_REFUSED = 1, KIND_TIFF = 2, KIND_UNREADABLE = 3, KIND_END = 4 };

// Per-image metadata, one int32 array (mirrored in data/jpeg_plain.py).
constexpr int META_INTS = 256;
enum MetaField {
  M_KIND = 0, M_WIDTH, M_HEIGHT, M_NCOMP, M_MAX_H, M_MAX_V, M_OUT_W, M_OUT_H,
  M_SCALE, M_COLOR, M_RESTART, M_COEFS, M_SOF, M_SOURCE,
};
// M_SOURCE, a JPEG segment of a TIFF: the segment whose decode its place in
// the raster shows (itself, or an earlier one, which libtiff's segment
// buffer keeps past a segment that fails).
constexpr int COMP_BASE = 16, COMP_INTS = 80, COMP_QT = 16;
enum CompField { C_H = 0, C_V, C_S, C_K, C_BW, C_BH, C_OFF, C_DW, C_DH };
enum Color { COLOR_GREY = 0, COLOR_YCC = 1, COLOR_RGB = 2 };

// A TIFF's metadata (M_KIND KIND_TIFF): M_WIDTH, M_HEIGHT, M_OUT_W and
// M_OUT_H its size, M_COEFS its JPEG segments' coefficients, and from
// COMP_BASE on (a TIFF has no components of its own):
enum TiffField { T_ROUTE = COMP_BASE, T_SEGMENTS, T_SEG_W, T_SEG_H, T_ACROSS, T_TILED, T_FLIP };
// T_ROUTE: TIFF_RASTER, RGB pixels decoded on the host; TIFF_JPEG, JPEG
// strips or tiles (compression 7) as entropy-decoded segments for the
// decode kernel; TIFF_PIL, a compression this reader does not decode;
// TIFF_SKIP, what libtiff's RGBA interface refuses.
enum TiffRoute { TIFF_RASTER = 0, TIFF_JPEG = 1, TIFF_PIL = 2, TIFF_SKIP = 3 };
// T_FLIP: 1 each row reversed, 2 the rows in reverse order.

// Bytes left uninitialised until written (a raster's every pixel is).
struct Bytes {
  std::unique_ptr<uint8_t[]> data;
  size_t size = 0;
  void resize(size_t n) {
    data.reset(n ? new uint8_t[n] : nullptr);
    size = n;
  }
};

struct TiffImage {
  int32_t meta[META_INTS] = {};
  Bytes rgb;                    // TIFF_RASTER: M_HEIGHT x M_WIDTH x 3
  std::vector<int32_t> metas;   // TIFF_JPEG: META_INTS per segment, in file order
  std::vector<int16_t> coef;    // TIFF_JPEG: the segments' coefficients, back to back
};

// Read a TIFF's first image: route it and, when pixels is true, decode it.
void read_tiff(const uint8_t* d, size_t n, bool pixels, TiffImage* out);

// An RFC 1950 zlib stream of cc bytes at src into out[0, occ), read as
// tif_zip.c 4.5.0 reads a Deflate strip through libdeflate 1.14
// (INFLATE_LIBDEFLATE), or as zlib 1.2.13's inflate() fills a buffer of occ
// bytes for tif_pixarlog.c (INFLATE_ZLIB). True where that decode succeeds.
enum InflateAs { INFLATE_LIBDEFLATE = 0, INFLATE_ZLIB = 1 };
bool inflate_zlib(const uint8_t* src, size_t cc, uint8_t* out, size_t occ, int as);

// T.81 Table D.2 (T.82 Table 24) in jaricom.c's layout: Qe_Value << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is
// libjpeg's fixed 0.5 bin. Shared by jpeg_entropy.cc's arithmetic decoder
// and jbig_decode.cc's.
extern const int32_t kAriTab[114];

// Entropy-decode one JPEG stream at 8/8 with the tables of a TIFF's
// JPEGTables in front (tables may be null): fills meta and appends the
// coefficients to coef (when coef is not null; the markers after a
// one-scan stream's scan unread). Returns the Kind.
int decode_jpeg_segment(const uint8_t* tables, size_t tlen, const uint8_t* d, size_t n, int32_t* meta,
                        std::vector<int16_t>* coef);

}  // namespace aq
