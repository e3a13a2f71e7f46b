// The WebP codec of the device loader's TIFF reader (csrc/tiff_decode.cc,
// compression 50001): the pixels libtiff 4.5.0's tif_webp.c gets from
// libwebp 1.2.4, byte for byte, linking nothing. Built into the loader's
// library (data/native_loader.py).
#pragma once

#include <cstddef>
#include <cstdint>

namespace aq {

// The size WebPGetFeatures gives a stream (ParseHeadersInternal without
// all the data).
struct WebpFeatures {
  int width = 0, height = 0;
};

// True where WebPGetInfo / WebPGetFeatures succeed on the n bytes at d.
bool webp_features(const uint8_t* d, size_t n, WebpFeatures* f);

// Decode the n bytes at d as WebPINewDecoder + one WebPIAppend of them all
// does, into the caller's buffer out of size bytes, rows stride bytes apart
// (channels 3 for MODE_RGB, 4 for MODE_RGBA with straight alpha), at the
// stream's own width and height: a stream the buffer cannot take (wider
// than stride, or taller than size) writes nothing and fails. Returns
// WebPIAppend's status: WEBP_OK when every row came out, WEBP_SUSPENDED
// where the data end early, WEBP_ERROR. *rows: the rows from the top
// written into out, all of them, or else the rows libwebp had already let
// out (VP8L: whole groups of 16; VP8: those its loop filter and fancy
// upsampler had released), the rest of out untouched.
enum WebpStatus { WEBP_OK = 0, WEBP_SUSPENDED = 1, WEBP_ERROR = 2 };
int webp_decode(const uint8_t* d, size_t n, int channels, uint8_t* out, size_t stride, size_t size, int* rows);

}  // namespace aq
