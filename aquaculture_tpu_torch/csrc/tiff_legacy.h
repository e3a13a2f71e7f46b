// Four codecs of the device loader's TIFF reader (csrc/tiff_decode.cc) that
// libtiff 4.5.0 has from before TIFF 6.0's baseline: NeXT (32766),
// ThunderScan (32809), PixarLog (32909) and SGILog (34676 LogL and LogLuv,
// 34677 LogLuv24), each as its tif_*.c decodes one strip or tile at the
// RGBA interface's settings. Built into the loader's library
// (data/native_loader.py).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace aq {

// tif_next.c's NeXTDecode of the cc bytes at src into out[0, occ): occ set
// to 0xff first, then rows of `scanline` bytes (tif_scanlinesize: the
// image's row, in a tile too) of literal rows, literal spans and runs of 2-bit
// pixels, a run stopping at `width` pixels (the tile's width in a tile).
// True where libtiff's decode succeeds: data that end at the start of a row
// leave the rows after it white.
bool next_decode(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, uint64_t scanline, uint32_t width);

// tif_thunder.c's ThunderDecodeRow: rows of `scanline` bytes, each `width`
// 4-bit pixels of raw values, 2- and 3-bit deltas and runs; true where every
// row has exactly its pixels.
bool thunder_decode(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, uint64_t scanline, uint32_t width);

// tif_pixarlog.c's PixarLogDecode at the data format PixarLogGuessDataFmt
// takes for 8 or 16 unsigned bits: the zlib stream inflated as zlib does
// into 11-bit words (swabbed where the file's byte order is not the
// host's), accumulated along rows of stride x width words (the image's
// width, in a tile too) and mapped through PixarLogMakeTables' ToLinear8 or
// ToLinear16. Nothing is written unless the decode succeeds.
struct PixarLogShape {
  int stride = 1;          // samples a pixel (1 in a planar file)
  uint32_t width = 0;      // the image's width
  bool sixteen = false;    // PIXARLOGDATAFMT_16BIT, else 8BIT
  bool swab = false;       // TIFF_SWAB
  uint64_t tbuf_size = 0;  // the codec's buffer in bytes (PixarLogSetupDecode)
};
bool pixarlog_decode(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, const PixarLogShape& shape,
                     std::vector<uint16_t>* tbuf);

// tif_luv.c's LogLuvDecodeStrip / LogLuvDecodeTile at SGILOGDATAFMT_8BIT
// (which TIFFRGBAImageBegin sets): rows of `rowlen` bytes, each decoded by
// LogL16Decode into L16toGry's grey, or by LogLuvDecode32 / LogLuvDecode24
// into Luv32toRGB's / Luv24toRGB's RGB, until a row fails (it and the rows
// after it unwritten). tbuflen: the codec's buffer in pixels.
enum SgiLogKind { SGILOG_L16 = 0, SGILOG_LUV32 = 1, SGILOG_LUV24 = 2 };
bool sgilog_decode(const uint8_t* src, size_t cc, uint8_t* out, uint64_t occ, uint64_t rowlen, int kind,
                   uint64_t tbuflen);

}  // namespace aq
