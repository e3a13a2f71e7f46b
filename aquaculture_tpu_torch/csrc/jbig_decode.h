// The JBIG codec of the device loader's TIFF reader (csrc/tiff_decode.cc,
// compression 34661): tif_jbig.c 4.5.0 over jbigkit 2.1's decoder
// (jbg_newlen, jbg_dec_in), which libtiff links as libjbig, for BIEs of one
// resolution layer and one bit plane, linking nothing. Built into the
// loader's library (data/native_loader.py).
#pragma once

#include <cstddef>
#include <cstdint>

namespace aq {

// Whether the n bytes at raw (bit-reversed first when reverse is true, as
// JBIGDecode does at FillOrder 1) begin with a BIH that jbg_dec_in accepts
// and that has differential layers (D > 0) or more than one plane (P > 1):
// BIEs this codec does not decode.
bool jbig_layered(const uint8_t* raw, size_t n, bool reverse);

// JBIGDecode of one strip: reversed as above, jbg_newlen's YD from a NEWLEN
// marker, then jbg_dec_in over all n bytes. True where libtiff's decode
// succeeds: jbg_dec_in decodes every stripe and the image (plane 0,
// ceil(XD / 8) x YD bytes) is no larger than occ; it is then copied to the
// start of out, the rest of out untouched. False (out untouched) where the
// BIE is refused, ends early, is aborted, or is larger than occ.
bool jbig_decode(const uint8_t* raw, size_t n, bool reverse, uint8_t* out, uint64_t occ);

}  // namespace aq
