// Esri's Lerc2 (libLerc 4.0's lerc_getBlobInfo and lerc_decode) for the
// TIFF reader's compression 34887. Built into the loader's library with
// tiff_decode.cc; links nothing.
#pragma once

#include <cstddef>
#include <cstdint>

namespace aq {

// lerc_getBlobInfo's infoArray as tif_lerc.c reads it.
struct LercInfo {
  int version = 0, data_type = 0, depth = 0, cols = 0, rows = 0, bands = 0, valid = 0;
  uint32_t blob_size = 0;
};

// The info of the blob of n bytes at src: false where libLerc's call fails.
bool lerc_info(const uint8_t* src, size_t n, LercInfo* info);

// lerc_decode(src, n, mask ? 1 : 0, mask, depth, cols, rows, 1, data_type,
// out): the pixels (depth values a pixel, data_type's bytes each) into out,
// and where mask is not null one byte a pixel (1 valid, 0 not). False where
// libLerc's call fails.
bool lerc_decode(const uint8_t* src, size_t n, int depth, int cols, int rows, int data_type, uint8_t* out,
                 uint8_t* mask);

}  // namespace aq
