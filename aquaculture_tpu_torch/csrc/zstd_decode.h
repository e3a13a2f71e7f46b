// Zstandard (RFC 8878) as libzstd 1.5.4 decodes it, for the TIFF reader's
// compression 50000 and LERC's Zstandard wrapper. Built into the loader's
// library with tiff_decode.cc; links nothing.
#pragma once

#include <cstddef>
#include <cstdint>

namespace aq {

// tif_zstd.c 4.5.0's ZSTDDecode of one strip or tile: ZSTD_decompressStream
// on a fresh stream over the cc bytes at src into out[0, occ), called until
// its first frame ends, the input runs out or out is full. True where
// libtiff's decode succeeds (occ bytes out, no error on the way); what came
// out stays in out either way.
bool zstd_tiff_decode(const uint8_t* src, size_t cc, uint8_t* out, size_t occ);

// ZSTD_decompress(dst, cap, src, n), as tif_lerc.c calls it: every frame of
// src (skippable ones skipped) into dst. The bytes out, or -1 where libzstd
// returns an error.
int64_t zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap);

}  // namespace aq
