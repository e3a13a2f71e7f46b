"""The plain PyTorch version of the JPEG reconstruction kernel.

The port's JPEG decoder runs in two halves: the host entropy decode
(csrc/jpeg_entropy.cc) gives each image's de-zigzagged, still-quantised
int16 coefficients and their metadata; the reconstruction (dequantisation,
integer IDCT, chroma upsampling, YCbCr->RGB, the crop and the tile grid)
runs in the hand-written kernel of csrc/jpeg_decode.cu on the card, and
here, in int32 tensor code, on the CPU. The tests hold this module against
PIL's and the JAX package's libjpeg-turbo decodes byte for byte, and
chip_smoke.py holds the kernel against it with ``torch.equal``.

The arithmetic is libjpeg-turbo's, reproduced exactly, not approximated:
- the IDCT that jddctmgr.c picks for each component's scaled size S:
  ``jpeg_idct_islow`` for 8x8 (CONST_BITS 13, PASS1_BITS 2), jidctred.c's
  ``jpeg_idct_1x1``, ``jpeg_idct_2x2`` and ``jpeg_idct_4x4`` (which read
  indices 0, 1, 3, 5, 7 and 0-3, 5-7 of the 8 x 8 coefficients), and
  jidctint.c's ``jpeg_idct_3x3`` .. ``jpeg_idct_7x7`` (N x N coefficients)
  and ``jpeg_idct_10x10``, ``12x12``, ``14x14`` (8 x 8 in, 4:2:0 chroma at
  5/8, 6/8 and 7/8, so that it needs no upsampling), each ending in
  libjpeg's range-limit table (the descaled value's low 10 bits, read as
  signed, plus 128, clamped to 0..255);
- jdsample.c's "fancy" (triangle-filter) h2v1, h1v2 and h2v2 upsampling,
  with its edge replication, and the box upsampling it falls back to
  (always at 1/8, and for the integral factors 3 and 4);
- jdcolor.c's 16-bit fixed-point YCbCr->RGB tables with ONE_HALF rounding,
  its grey replication, and its copy of RGB-coded components.
The kernel runs them fused, stripe by stripe (``stripe_blocks`` gives the
blocks one of its CTAs reads); ``decode_batch_plain`` is its plain version,
the IDCT into whole planes (``idct_batch_plain``) followed by the colour
pass over them (``color_batch_plain``).
The sums fit int32 for every coefficient that an encoder makes from 8-bit
samples (libjpeg computes in 64-bit ``JLONG``); the 8x8 SIMD IDCT of
libjpeg-turbo saturates where the table wraps, which only coefficients out
of that range can tell apart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

# The metadata layout of csrc/tiff_decode.h (one int32 array per image).
META_INTS = 256
M_KIND, M_WIDTH, M_HEIGHT, M_NCOMP, M_MAX_H, M_MAX_V, M_OUT_W, M_OUT_H = range(8)
M_SCALE, M_COLOR, M_RESTART, M_COEFS, M_SOF, M_SOURCE = range(8, 14)
MC_BASE, MC_INTS, MC_QT = 16, 80, 16   # one component's fields in the metadata
C_H, C_V, C_S, C_K, C_BW, C_BH, C_OFF, C_DW, C_DH = range(9)
# KIND_BASELINE: the entropy decoder takes the file (any JPEG process that
# libjpeg-turbo decodes); KIND_REFUSED: a JPEG that libjpeg-turbo refuses;
# KIND_UNREADABLE: neither JPEG nor TIFF, or markers that do not parse
KIND_BASELINE, KIND_REFUSED, KIND_TIFF, KIND_UNREADABLE = range(4)
# A TIFF's fields (M_KIND KIND_TIFF; csrc/tiff_decode.h): its route, its
# JPEG segments (count, size, segments across, tiled or stripped) and the
# orientation's flips (1 each row reversed, 2 the rows reversed)
T_ROUTE, T_SEGMENTS, T_SEG_W, T_SEG_H, T_ACROSS, T_TILED, T_FLIP = range(MC_BASE, MC_BASE + 7)
# T_ROUTE: pixels decoded on the host, JPEG segments for the kernel, a
# compression left to PIL, refused as libtiff's RGBA interface refuses it
TIFF_RASTER, TIFF_JPEG, TIFF_PIL, TIFF_SKIP = range(4)
COLOR_GREY, COLOR_YCC, COLOR_RGB = range(3)   # M_COLOR: jdcolor.c's conversion to RGB

# Upsampling modes of one component (shared with csrc/jpeg_decode.cu).
UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_BOX = range(5)

CONST_BITS = 13
PASS1_BITS = 2


def _fix(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


# jidctint.c's constants, FIX(x) = x * 2**13 rounded
F_0_298631336, F_0_390180644, F_0_541196100, F_0_765366865 = 2446, 3196, 4433, 6270
F_0_899976223, F_1_175875602, F_1_501321110, F_1_847759065 = 7373, 9633, 12299, 15137
F_1_961570560, F_2_053119869, F_2_562915447, F_3_072711026 = 16069, 16819, 20995, 25172


@dataclasses.dataclass
class Component:
    h: int          # sampling factors
    v: int
    size: int       # scaled IDCT size S: each block gives S x S samples
    kept: int       # K: coefficients kept per block side (``kept(S)``)
    blocks_w: int
    blocks_h: int
    offset: int     # into the image's coefficients, in int16 values
    width: int      # downsampled size after the IDCT (libjpeg's downsampled_width)
    height: int
    qtable: np.ndarray  # (8, 8) natural order


@dataclasses.dataclass
class EntropyImage:
    """One image out of the host entropy decode: its metadata (the int32
    array of csrc/jpeg_entropy.cc) and its coefficients (int16, each
    component's blocks in raster order, K x K each)."""

    meta: np.ndarray
    coef: torch.Tensor

    @property
    def out_width(self) -> int:
        return int(self.meta[M_OUT_W])

    @property
    def out_height(self) -> int:
        return int(self.meta[M_OUT_H])

    @property
    def components(self) -> List[Component]:
        return components_of(self.meta)


def components_of(meta: np.ndarray) -> List[Component]:
    out = []
    for c in range(int(meta[M_NCOMP])):
        m = meta[MC_BASE + MC_INTS * c:MC_BASE + MC_INTS * (c + 1)]
        out.append(Component(
            h=int(m[C_H]), v=int(m[C_V]), size=int(m[C_S]), kept=int(m[C_K]),
            blocks_w=int(m[C_BW]), blocks_h=int(m[C_BH]), offset=int(m[C_OFF]),
            width=int(m[C_DW]), height=int(m[C_DH]),
            qtable=np.asarray(m[MC_QT:MC_QT + 64], np.int32).reshape(8, 8)))
    return out


def upsample_mode(comp: Component, meta: np.ndarray) -> Tuple[int, int, int]:
    """(mode, h factor, v factor) of one component: jdsample.c's choice,
    with the input group scaled by the component's IDCT size."""
    min_size = int(meta[M_SCALE])
    h_in = comp.h * comp.size // min_size
    v_in = comp.v * comp.size // min_size
    h_out, v_out = int(meta[M_MAX_H]), int(meta[M_MAX_V])
    fancy = min_size > 1
    if h_in == h_out and v_in == v_out:
        return UP_FULL, 1, 1
    if h_in * 2 == h_out and v_in == v_out and fancy and comp.width > 2:
        return UP_H2V1, 2, 1
    if h_in == h_out and v_in * 2 == v_out and fancy:
        return UP_H1V2, 1, 2
    if h_in * 2 == h_out and v_in * 2 == v_out and fancy and comp.width > 2:
        return UP_H2V2, 2, 2
    if h_out % h_in or v_out % v_in:
        raise ValueError(f"sampling {comp.h}x{comp.v} of {h_out}x{v_out} has no integral upsampling")
    return UP_BOX, h_out // h_in, v_out // v_in


# ---------------------------------------------------------------- IDCT

def range_limit(x: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range limit: the low 10 bits read as signed,
    plus 128, clamped to 0..255."""
    t = x & 1023
    t = torch.where(t >= 512, t - 1024, t)
    return (t + 128).clamp(0, 255)


def _islow_1d(z: List[torch.Tensor]) -> List[torch.Tensor]:
    """One 8-point pass of jpeg_idct_islow, before its descale."""
    z2, z3 = z[2], z[6]
    z1 = (z2 + z3) * F_0_541196100
    tmp2 = z1 + z3 * -F_1_847759065
    tmp3 = z1 + z2 * F_0_765366865
    tmp0 = (z[0] + z[4]) * (1 << CONST_BITS)
    tmp1 = (z[0] - z[4]) * (1 << CONST_BITS)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = z[7], z[5], z[3], z[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175875602
    t0 = t0 * F_0_298631336
    t1 = t1 * F_2_053119869
    t2 = t2 * F_3_072711026
    t3 = t3 * F_1_501321110
    z1 = z1 * -F_0_899976223
    z2 = z2 * -F_2_562915447
    z3 = z3 * -F_1_961570560 + z5
    z4 = z4 * -F_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


# Each 1-D pass below takes its inputs z[0..] (coefficients, or the
# workspace) and returns its outputs: pass 1's workspace values, or pass
# 2's samples before the range limit (``second``).
OUT_SHIFT = CONST_BITS + PASS1_BITS + 3   # jidctint.c's last shift, its rounding added up front
FUDGE = 1 << (CONST_BITS - PASS1_BITS - 1)


def _islow_pass(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    n = OUT_SHIFT if second else CONST_BITS - PASS1_BITS
    return [_descale(o, n) for o in _islow_1d(z)]


def _dc_term(z0: torch.Tensor, second: bool) -> torch.Tensor:
    """jidctint.c's even-part start: the DC scaled up, with the rounding of
    the pass's final shift (pass 2 adds it before the scaling)."""
    if second:
        return (z0 + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
    return z0 * (1 << CONST_BITS) + FUDGE


def _shifted(out: List[torch.Tensor], second: bool, keep=()) -> List[torch.Tensor]:
    """The pass's final shift (pass 1: CONST_BITS - PASS1_BITS, but the
    outputs in ``keep``, already at pass-1 scale; pass 2: OUT_SHIFT)."""
    if second:
        return [o >> OUT_SHIFT for o in out]
    return [o if i in keep else o >> (CONST_BITS - PASS1_BITS) for i, o in enumerate(out)]


def _red1(d: torch.Tensor) -> torch.Tensor:
    """jpeg_idct_1x1: the DC, descaled by 3."""
    return range_limit(_descale(d[:, :1, :1], 3))


def _red2_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctred.c's jpeg_idct_2x2 (reads indices 0, 1, 3, 5, 7)."""
    tmp10 = z[0] * (1 << (CONST_BITS + 2))
    tmp0 = z[7] * -_fix(0.720959822) + z[5] * _fix(0.850430095) + z[3] * -_fix(1.272758580) \
        + z[1] * _fix(3.624509785)
    n = CONST_BITS + PASS1_BITS + 3 + 2 if second else CONST_BITS - PASS1_BITS + 2
    return [_descale(tmp10 + tmp0, n), _descale(tmp10 - tmp0, n)]


def _red4_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctred.c's jpeg_idct_4x4 (reads indices 0-3, 5-7)."""
    tmp0 = z[0] * (1 << (CONST_BITS + 1))
    tmp2 = z[2] * F_1_847759065 + z[6] * -F_0_765366865
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = z[7], z[5], z[3], z[1]
    tmp0 = z1 * -_fix(0.211164243) + z2 * _fix(1.451774981) + z3 * -_fix(2.172734803) + z4 * _fix(1.061594337)
    tmp2 = z1 * -_fix(0.509795579) + z2 * -_fix(0.601344887) + z3 * F_0_899976223 + z4 * F_2_562915447
    n = CONST_BITS + PASS1_BITS + 3 + 1 if second else CONST_BITS - PASS1_BITS + 1
    return [_descale(o, n) for o in (tmp10 + tmp2, tmp12 + tmp0, tmp12 - tmp0, tmp10 - tmp2)]


def _idct3_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_3x3."""
    tmp0 = _dc_term(z[0], second)
    tmp12 = z[2] * _fix(0.707106781)
    tmp10, tmp2 = tmp0 + tmp12, tmp0 - tmp12 - tmp12
    tmp0 = z[1] * _fix(1.224744871)
    return _shifted([tmp10 + tmp0, tmp2, tmp10 - tmp0], second)


def _idct5_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_5x5."""
    tmp12 = _dc_term(z[0], second)
    tmp0, tmp1 = z[2], z[4]
    z1 = (tmp0 + tmp1) * _fix(0.790569415)
    z2 = (tmp0 - tmp1) * _fix(0.353553391)
    z3 = tmp12 + z2
    tmp10, tmp11 = z3 + z1, z3 - z1
    tmp12 = tmp12 - z2 * 4
    z2, z3 = z[1], z[3]
    z1 = (z2 + z3) * _fix(0.831253876)
    tmp0 = z1 + z2 * _fix(0.513743148)
    tmp1 = z1 - z3 * _fix(2.176250899)
    return _shifted([tmp10 + tmp0, tmp11 + tmp1, tmp12, tmp11 - tmp1, tmp10 - tmp0], second)


def _idct6_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_6x6."""
    tmp0 = _dc_term(z[0], second)
    tmp10 = z[4] * _fix(0.707106781)
    tmp1 = tmp0 + tmp10
    tmp11 = tmp0 - tmp10 - tmp10
    if not second:
        tmp11 = tmp11 >> (CONST_BITS - PASS1_BITS)
    tmp0 = z[2] * _fix(1.224744871)
    tmp10, tmp12 = tmp1 + tmp0, tmp1 - tmp0
    z1, z2, z3 = z[1], z[3], z[5]
    tmp1 = (z1 + z3) * _fix(0.366025404)
    tmp0 = tmp1 + (z1 + z2) * (1 << CONST_BITS)
    tmp2 = tmp1 + (z3 - z2) * (1 << CONST_BITS)
    tmp1 = (z1 - z2 - z3) * (1 << (CONST_BITS if second else PASS1_BITS))
    return _shifted([tmp10 + tmp0, tmp11 + tmp1, tmp12 + tmp2, tmp12 - tmp2, tmp11 - tmp1, tmp10 - tmp0],
                    second, keep=(1, 4))


def _idct7_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_7x7."""
    tmp13 = _dc_term(z[0], second)
    z1, z2, z3 = z[2], z[4], z[6]
    tmp10 = (z2 - z3) * _fix(0.881747734)
    tmp12 = (z1 - z2) * _fix(0.314692123)
    tmp11 = tmp10 + tmp12 + tmp13 - z2 * _fix(1.841218003)
    tmp0 = z1 + z3
    z2 = z2 - tmp0
    tmp0 = tmp0 * _fix(1.274162392) + tmp13
    tmp10 = tmp10 + tmp0 - z3 * _fix(0.077722536)
    tmp12 = tmp12 + tmp0 - z1 * _fix(2.470602249)
    tmp13 = tmp13 + z2 * _fix(1.414213562)
    z1, z2, z3 = z[1], z[3], z[5]
    tmp1 = (z1 + z2) * _fix(0.935414347)
    tmp2 = (z1 - z2) * _fix(0.170262339)
    tmp0 = tmp1 - tmp2
    tmp1 = tmp1 + tmp2
    tmp2 = (z2 + z3) * -_fix(1.378756276)
    tmp1 = tmp1 + tmp2
    z2 = (z1 + z3) * _fix(0.613604268)
    tmp0 = tmp0 + z2
    tmp2 = tmp2 + z2 + z3 * _fix(1.870828693)
    return _shifted([tmp10 + tmp0, tmp11 + tmp1, tmp12 + tmp2, tmp13, tmp12 - tmp2, tmp11 - tmp1,
                     tmp10 - tmp0], second)


def _idct10_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_10x10 (8 inputs)."""
    z3 = _dc_term(z[0], second)
    z4 = z[4]
    z1 = z4 * _fix(1.144122806)
    z2 = z4 * _fix(0.437016024)
    tmp10, tmp11 = z3 + z1, z3 - z2
    tmp22 = z3 - (z1 - z2) * 2
    if not second:
        tmp22 = tmp22 >> (CONST_BITS - PASS1_BITS)
    z2, z3 = z[2], z[6]
    z1 = (z2 + z3) * _fix(0.831253876)
    tmp12 = z1 + z2 * _fix(0.513743148)
    tmp13 = z1 - z3 * _fix(2.176250899)
    tmp20, tmp24 = tmp10 + tmp12, tmp10 - tmp12
    tmp21, tmp23 = tmp11 + tmp13, tmp11 - tmp13

    z1, z2, z3, z4 = z[1], z[3], z[5], z[7]
    tmp11, tmp13 = z2 + z4, z2 - z4
    tmp12 = tmp13 * _fix(0.309016994)
    z5 = z3 * (1 << CONST_BITS)
    z2 = tmp11 * _fix(0.951056516)
    z4 = z5 + tmp12
    tmp10 = z1 * _fix(1.396802247) + z2 + z4
    tmp14 = z1 * _fix(0.221231742) - z2 + z4
    z2 = tmp11 * _fix(0.587785252)
    z4 = z5 - tmp12 - tmp13 * (1 << (CONST_BITS - 1))
    if second:
        tmp12 = (z1 - tmp13) * (1 << CONST_BITS) - z5
    else:
        tmp12 = (z1 - tmp13 - z3) * (1 << PASS1_BITS)
    tmp11 = z1 * _fix(1.260073511) - z2 - z4
    tmp13 = z1 * _fix(0.642039522) - z2 + z4
    return _shifted([tmp20 + tmp10, tmp21 + tmp11, tmp22 + tmp12, tmp23 + tmp13, tmp24 + tmp14,
                     tmp24 - tmp14, tmp23 - tmp13, tmp22 - tmp12, tmp21 - tmp11, tmp20 - tmp10],
                    second, keep=(2, 7))


def _idct12_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_12x12 (8 inputs)."""
    z3 = _dc_term(z[0], second)
    z4 = z[4] * _fix(1.224744871)
    tmp10, tmp11 = z3 + z4, z3 - z4
    z1 = z[2]
    z4 = z1 * _fix(1.366025404)
    z1 = z1 * (1 << CONST_BITS)
    z2 = z[6] * (1 << CONST_BITS)
    tmp12 = z1 - z2
    tmp21, tmp24 = z3 + tmp12, z3 - tmp12
    tmp12 = z4 + z2
    tmp20, tmp25 = tmp10 + tmp12, tmp10 - tmp12
    tmp12 = z4 - z1 - z2
    tmp22, tmp23 = tmp11 + tmp12, tmp11 - tmp12

    z1, z2, z3, z4 = z[1], z[3], z[5], z[7]
    tmp11 = z2 * _fix(1.306562965)
    tmp14 = z2 * -F_0_541196100
    tmp10 = z1 + z3
    tmp15 = (tmp10 + z4) * _fix(0.860918669)
    tmp12 = tmp15 + tmp10 * _fix(0.261052384)
    tmp10 = tmp12 + tmp11 + z1 * _fix(0.280143716)
    tmp13 = (z3 + z4) * -_fix(1.045510580)
    tmp12 = tmp12 + tmp13 + tmp14 - z3 * _fix(1.478575242)
    tmp13 = tmp13 + tmp15 - tmp11 + z4 * _fix(1.586706681)
    tmp15 = tmp15 + tmp14 - z1 * _fix(0.676326758) - z4 * _fix(1.982889723)
    z1 = z1 - z4
    z2 = z2 - z3
    z3 = (z1 + z2) * F_0_541196100
    tmp11 = z3 + z1 * F_0_765366865
    tmp14 = z3 - z2 * F_1_847759065
    return _shifted([tmp20 + tmp10, tmp21 + tmp11, tmp22 + tmp12, tmp23 + tmp13, tmp24 + tmp14,
                     tmp25 + tmp15, tmp25 - tmp15, tmp24 - tmp14, tmp23 - tmp13, tmp22 - tmp12,
                     tmp21 - tmp11, tmp20 - tmp10], second)


def _idct14_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One pass of jidctint.c's jpeg_idct_14x14 (8 inputs)."""
    z1 = _dc_term(z[0], second)
    z4 = z[4]
    z2 = z4 * _fix(1.274162392)
    z3 = z4 * _fix(0.314692123)
    z4 = z4 * _fix(0.881747734)
    tmp10, tmp11, tmp12 = z1 + z2, z1 + z3, z1 - z4
    tmp23 = z1 - (z2 + z3 - z4) * 2
    if not second:
        tmp23 = tmp23 >> (CONST_BITS - PASS1_BITS)
    z1, z2 = z[2], z[6]
    z3 = (z1 + z2) * _fix(1.105676686)
    tmp13 = z3 + z1 * _fix(0.273079590)
    tmp14 = z3 - z2 * _fix(1.719280954)
    tmp15 = z1 * _fix(0.613604268) - z2 * _fix(1.378756276)
    tmp20, tmp26 = tmp10 + tmp13, tmp10 - tmp13
    tmp21, tmp25 = tmp11 + tmp14, tmp11 - tmp14
    tmp22, tmp24 = tmp12 + tmp15, tmp12 - tmp15

    z1, z2, z3 = z[1], z[3], z[5]
    w4 = z[7] * (1 << CONST_BITS)
    tmp14 = z1 + z3
    tmp11 = (z1 + z2) * _fix(1.334852607)
    tmp12 = tmp14 * _fix(1.197448846)
    tmp10 = tmp11 + tmp12 + w4 - z1 * _fix(1.126980169)
    tmp14 = tmp14 * _fix(0.752406978)
    tmp16 = tmp14 - z1 * _fix(1.061150426)
    z1 = z1 - z2
    tmp15 = z1 * _fix(0.467085129) - w4
    tmp16 = tmp16 + tmp15
    t = (z2 + z3) * -_fix(0.158341681) - w4
    tmp11 = tmp11 + t - z2 * _fix(0.424103948)
    tmp12 = tmp12 + t - z3 * _fix(2.373959773)
    t = (z3 - z2) * _fix(1.405321284)
    tmp14 = tmp14 + t + w4 - z3 * _fix(1.6906431334)
    tmp15 = tmp15 + t + z2 * _fix(0.674957567)
    s = CONST_BITS if second else PASS1_BITS
    tmp13 = (z1 - z3) * (1 << s) + z[7] * (1 << s)
    return _shifted([tmp20 + tmp10, tmp21 + tmp11, tmp22 + tmp12, tmp23 + tmp13, tmp24 + tmp14,
                     tmp25 + tmp15, tmp26 + tmp16, tmp26 - tmp16, tmp25 - tmp15, tmp24 - tmp14,
                     tmp23 - tmp13, tmp22 - tmp12, tmp21 - tmp11, tmp20 - tmp10], second, keep=(3, 10))


# the 1-D pass of each scaled IDCT size (1x1 has none: ``_red1``)
IDCT_PASSES = {2: _red2_1d, 3: _idct3_1d, 4: _red4_1d, 5: _idct5_1d, 6: _idct6_1d, 7: _idct7_1d,
               8: _islow_pass, 10: _idct10_1d, 12: _idct12_1d, 14: _idct14_1d}


def kept_index(size: int) -> Tuple[int, ...]:
    """The coefficient indices of each axis that the IDCT of ``size``
    reads, in order: the block's kept K x K square (``kept``) holds these
    rows and columns. jidctred.c's 2x2 reads 0, 1, 3, 5, 7 and its 4x4
    0-3 and 5-7; the others read 0 .. min(size, 8) - 1 (the 1x1 the DC)."""
    if size == 2:
        return (0, 1, 3, 5, 7)
    if size == 4:
        return (0, 1, 2, 3, 5, 6, 7)
    return tuple(range(min(size, 8)))


def kept(size: int) -> int:
    """K: the coefficients a side that the IDCT of ``size`` reads (and the
    entropy decoder keeps, ``kept_index``)."""
    return len(kept_index(size))


def _spread(z: List[torch.Tensor], index: Tuple[int, ...]) -> List[torch.Tensor]:
    """A pass's inputs by coefficient index from the kept square's (the
    indices the IDCT does not read stay None)."""
    out = [None] * (index[-1] + 1)
    for i, v in zip(index, z):
        out[i] = v
    return out


def idct_plain(coeffs: torch.Tensor, qtable: torch.Tensor, size: int) -> torch.Tensor:
    """Dequantise and inverse-DCT blocks: coeffs (N, K, K) quantised
    coefficients, the kept square (``kept_index(size)`` of each axis),
    qtable (8, 8) or (N, 8, 8) in natural order -> (N, size, size) int32
    samples in 0..255, by the IDCT that libjpeg-turbo runs at that size."""
    if size != 1 and size not in IDCT_PASSES:
        raise ValueError(f"libjpeg has no scaled IDCT of size {size} (sizes {IDCT_SIZES})")
    index = kept_index(size)
    k = len(index)
    if coeffs.shape[-2:] != (k, k):
        raise ValueError(f"size {size} takes {k} x {k} coefficients; got {tuple(coeffs.shape)}")
    idx = torch.tensor(index)
    q = qtable.to(torch.int32)[..., idx, :][..., idx]
    d = coeffs.to(torch.int32) * q
    if size == 1:
        return _red1(d)
    one_d = IDCT_PASSES[size]
    # pass 1 over columns (rows of d are the 1-D inputs), pass 2 over rows
    ws = torch.stack(one_d(_spread(list(d.unbind(1)), index), False), 1)
    return torch.stack([range_limit(o) for o in one_d(_spread(list(ws.unbind(2)), index), True)], 2)


# ---------------------------------------------------------------- upsampling

def _shift(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """x moved by one sample along dim (step -1: each sample's predecessor,
    +1: its successor), the edge sample replicated."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device) + step
    return x.index_select(dim, idx.clamp(0, n - 1))


def upsample_fancy_plain(plane: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """jdsample.c's fancy upsampling of one (height, width) int32 plane by
    h x v (2x1, 1x2 or 2x2): triangle filters with the edge replicated,
    biases +1/+2 (>> 2) for one axis, +8/+7 (>> 4) for both."""
    x = plane.to(torch.int32)
    if (h, v) == (2, 1):
        t = x * 3
        even = (t + _shift(x, 1, -1) + 1) >> 2
        odd = (t + _shift(x, 1, 1) + 2) >> 2
        return torch.stack([even, odd], 2).reshape(x.shape[0], -1)
    if (h, v) == (1, 2):
        t = x * 3
        upper = (t + _shift(x, 0, -1) + 1) >> 2
        lower = (t + _shift(x, 0, 1) + 2) >> 2
        return torch.stack([upper, lower], 1).reshape(-1, x.shape[1])
    if (h, v) == (2, 2):
        rows = []
        for step in (-1, 1):  # the upper output row leans on the row above
            cs = x * 3 + _shift(x, 0, step)
            t = cs * 3
            even = (t + _shift(cs, 1, -1) + 8) >> 4
            odd = (t + _shift(cs, 1, 1) + 7) >> 4
            rows.append(torch.stack([even, odd], 2).reshape(x.shape[0], -1))
        return torch.stack(rows, 1).reshape(-1, 2 * x.shape[1])
    raise ValueError(f"fancy upsampling is 2x1, 1x2 or 2x2; got {h}x{v}")


def upsample_plain(plane: torch.Tensor, mode: int, h: int, v: int) -> torch.Tensor:
    if mode == UP_FULL:
        return plane
    if mode == UP_BOX:
        return plane.repeat_interleave(v, 0).repeat_interleave(h, 1)
    return upsample_fancy_plain(plane, h, v)


# ---------------------------------------------------------------- colour

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c's ycc_rgb_convert: int32 planes (H, W) -> (H, W, 3) uint8."""
    cb = cb.to(torch.int32) - 128
    cr = cr.to(torch.int32) - 128
    y = y.to(torch.int32)
    r = y + ((_fix16(1.40200) * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix16(0.34414) * cb + ONE_HALF - _fix16(0.71414) * cr) >> SCALEBITS)
    b = y + ((_fix16(1.77200) * cb + ONE_HALF) >> SCALEBITS)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------- batches
#
# A batch for the kernel is a set of images (their coefficients one after
# another in one int16 buffer) and a list of tile slots, described by int32
# arrays (the layout csrc/jpeg_decode.cu reads; plane_off and plane_w serve
# the plain version's planes only):
#   comps  (8 per component of each image): coef_off, plane_off, blocks_w,
#          blocks_h, K, S, qt_off, plane_w
#   images (20 per image): ncomp, first comp, out_w, out_h, colour (0 grey,
#          1 YCbCr, 2 RGB), then per component: mode, h factor, v factor,
#          downsampled width, downsampled height
#   tiles  (4 per slot): kind (TILE_ZERO, TILE_DECODED, TILE_CALLER),
#          image, x and y origin in decoded pixels
COMP_INTS, IMAGE_INTS, TILE_INTS = 8, 20, 4
TILE_ZERO, TILE_DECODED, TILE_CALLER = 0, 1, 2
IDCT_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14)  # libjpeg's scaled sizes at N/8, N = 1..8
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class BatchLayout:
    """Sizes of a packed descriptor array (``describe_batch``)."""

    n_comps: int
    n_images: int
    n_slots: int
    plane_bytes: int   # the plain IDCT's output: every component's plane
    band_unit: int     # the least common multiple of the images' MCU heights (``decode_grid``)
    scale: int = 8     # the N/8 the batch's images decode at (the kernel is built per scale)


def describe_batch(metas: Sequence[np.ndarray], coef_offsets: Sequence[int],
                   tiles: Sequence[Tuple[int, int, int, int]]) -> Tuple[np.ndarray, BatchLayout]:
    """Pack the descriptors of a batch into one int32 array [qt | comps |
    images | tiles]: ``metas`` the images' metadata, ``coef_offsets`` where
    each image's coefficients start in the batch's int16 buffer, ``tiles``
    one (kind, image, x, y) per slot. The images share one scale."""
    scales = sorted({int(m[M_SCALE]) for m in metas})
    if len(scales) > 1:
        raise ValueError(f"a batch decodes at one scale; its images are at {scales} (N/8)")
    n_comps = sum(int(m[M_NCOMP]) for m in metas)
    qt = np.zeros((n_comps, 64), np.int64)
    comps = np.zeros((n_comps, COMP_INTS), np.int64)
    images = np.zeros((len(metas), IMAGE_INTS), np.int64)
    ci = plane_off = 0
    band_unit = 1
    for i, (m, off) in enumerate(zip(metas, coef_offsets)):
        cs = components_of(m)
        images[i, :5] = (len(cs), ci, m[M_OUT_W], m[M_OUT_H], m[M_COLOR])
        for c, comp in enumerate(cs):
            if comp.size not in IDCT_SIZES:
                raise ValueError(f"libjpeg has no {comp.size}x{comp.size} IDCT (scale {m[M_SCALE]}/8)")
            mode, hf, vf = upsample_mode(comp, m)
            images[i, 5 + 5 * c:10 + 5 * c] = (mode, hf, vf, comp.width, comp.height)
            pw = comp.blocks_w * comp.size
            comps[ci] = (off + comp.offset, plane_off, comp.blocks_w, comp.blocks_h,
                         comp.kept, comp.size, 64 * ci, pw)
            qt[ci] = comp.qtable.ravel()
            plane_off += comp.blocks_h * comp.size * pw
            ci += 1
        _check_ring(comps[images[i, 1]:ci, 5].tolist(), images[i].tolist())
        band_unit = math.lcm(band_unit, mcu_rows(comps[images[i, 1]:ci, 5].tolist(), images[i].tolist()))
    t = np.asarray(tiles, np.int64).reshape(-1, TILE_INTS)
    packed = np.concatenate([qt.ravel(), comps.ravel(), images.ravel(), t.ravel()])
    if plane_off > _INT32_MAX or (n_comps and comps[:, 0].max() > _INT32_MAX):
        raise ValueError("a batch's coefficients or planes pass 2**31: use a smaller batch")
    return packed.astype(np.int32), BatchLayout(n_comps, len(metas), len(t), plane_off, band_unit,
                                                (scales or [8])[0])


def unpack_batch(packed: torch.Tensor, lay: BatchLayout):
    """Views (qt, comps, images, tiles) of a packed descriptor tensor, on
    its device."""
    sizes = (lay.n_comps * 64, lay.n_comps * COMP_INTS, lay.n_images * IMAGE_INTS,
             lay.n_slots * TILE_INTS)
    qt, comps, images, tiles = packed[:sum(sizes)].split(sizes)
    return (qt, comps.view(-1, COMP_INTS), images.view(-1, IMAGE_INTS), tiles.view(-1, TILE_INTS))


# ---------------------------------------------------------------- stripes
#
# The kernel's geometry (csrc/jpeg_decode.cu keeps the same constants and
# arithmetic; the wrapper checks the constants when it loads the library).
# One CTA owns a column stripe of STRIPE_W output pixels of one slot over a
# band of its rows, and walks down the image in steps of whole MCU rows
# (STEP_ROWS output rows or fewer): per step it inverse-transforms each
# component's new block rows under the stripe into a ring of sample rows in
# shared memory (the rows above and below too for a component upsampled
# vertically, as jdmainct.c's context rows), then upsamples and
# colour-converts the step's pixels out of the ring.
STRIPE_W = 128        # output pixels across one CTA
STEP_ROWS = 64        # output rows per step: as many whole MCU rows as fit
RING_ROWS = 64        # sample rows of one component's ring (at most 64 at 8/8, 60 at 5/8 and 6/8)
RING_PITCH = 176      # bytes per ring row (a multiple of 16; 44 words, so that a block's 8
                      # rows of stores fall on distinct banks): the widest stripe needs 154
                      # (11 blocks of 14x14 chroma at 7/8) and up to 15 of pad to put its
                      # runs on 16-byte boundaries, a 2x upsampler's RING_SLACK past them
RING_SLACK = 8        # bytes a 2x horizontal upsampler's word reads may pass a row's last
                      # sample (the other modes read no byte past it)
MIN_CTAS = 4096       # split tiles into bands until the grid has this many CTAs:
                      # about eight waves of 4 resident CTAs on an H100's 132 SMs
BAND_ROWS = 80        # the bands' step at BAND_ROWS_SCALES, where every MCU height divides
BAND_ROWS_SCALES = (8, 5)  # it (1024 px tiles at 8/8: 320-row bands, faster than 256: PERF.md §6)


def _fancy(mode: int) -> Tuple[bool, bool]:
    """Whether a component's fancy upsampling reads a neighbour sample
    across (h) and down (v)."""
    return mode in (UP_H2V1, UP_H2V2), mode in (UP_H1V2, UP_H2V2)


def _span(fancy: bool, factor: int, n: int, lo: int, hi: int) -> Tuple[int, int]:
    """Samples [a, b) of one component's axis that output pixels [lo, hi)
    read: the triangle filter's neighbours clamped to the n downsampled
    samples, or the box's sample under each pixel."""
    if fancy:
        return max((lo >> 1) - 1, 0), min(((hi - 1) >> 1) + 1, n - 1) + 1
    return lo // factor, (hi - 1) // factor + 1


def _ring_row_bytes(fancy: bool, factor: int, s: int) -> int:
    """The most bytes of a ring row that any stripe's STRIPE_W pixels
    take, whatever its origin: the blocks under the widest span of samples
    they read (``_span``: the triangle's neighbour on each side for a
    fancy upsampler) and the pad (up to 15) that puts the first run on a
    16-byte boundary."""
    factor = 2 if fancy else factor
    samples = -(-(STRIPE_W - 1) // factor) + (3 if fancy else 1)
    return (-(-(samples - 1) // s) + 1) * s + 15


def mcu_rows(sizes: Sequence[int], image: Sequence[int]) -> int:
    """An image's MCU height in output rows: its tallest component's block
    rows (IDCT size x vertical upsampling), e.g. 16 for 4:2:0 at 8/8, 14
    at 7/8, N for 4:4:4 at N/8."""
    return max(s * image[7 + 5 * c] for c, s in enumerate(sizes))


def _check_ring(sizes: Sequence[int], image: Sequence[int]) -> None:
    """Each component's rolling window (a step's block rows, and the rows
    above and below for a vertical upsampler) fits the kernel's ring, every
    component's block rows fall on the image's MCU rows, and the widest
    stripe at any origin fits a ring row: the kernel traps on a CTA past
    any of these (csrc/jpeg_decode.cu), so the batch is refused here."""
    rows = [s * image[7 + 5 * c] for c, s in enumerate(sizes)]   # output rows per block row
    mcu = mcu_rows(sizes, image)
    step = max(STEP_ROWS // mcu, 1) * mcu
    for c, (s, r) in enumerate(zip(sizes, rows)):
        mode, hf = image[5 + 5 * c:7 + 5 * c]
        fancy_h, fancy_v = _fancy(mode)
        window = step // r + 2 * fancy_v
        if mcu % r or window * s > RING_ROWS:
            raise ValueError(f"component {c}: {window} block rows of {s} samples per step; "
                             f"the kernel's ring holds {RING_ROWS} rows")
        width = _ring_row_bytes(fancy_h, hf, s)
        room = RING_PITCH - (RING_SLACK if fancy_h else 0)
        if width > room:
            raise ValueError(f"component {c}: a stripe's samples take up to {width} bytes of a ring row; "
                             f"the kernel's rows hold {room}")


def decode_grid(n_slots: int, th: int, tw: int, lay: BatchLayout) -> Tuple[int, int]:
    """(stripes, band rows) of the kernel's grid over (n_slots, th, tw, 3)
    for a batch of layout ``lay``: one CTA per stripe of STRIPE_W columns,
    slot and band; tiles split into bands until there are MIN_CTAS CTAs,
    each band a multiple of BAND_ROWS rows at BAND_ROWS_SCALES, else of the
    batch's MCU height (``BatchLayout.band_unit``): bands then start on
    whole MCU rows, no block row decoded twice. Any band is exact; the
    unit saves work."""
    step = BAND_ROWS if lay.scale in BAND_ROWS_SCALES else lay.band_unit
    stripes = -(-tw // STRIPE_W)
    bands = min(-(-MIN_CTAS // max(n_slots * stripes, 1)), -(-th // step))
    band_rows = -(-(-(-th // max(bands, 1))) // step) * step
    return stripes, band_rows


def stripe_blocks(comps, image: Sequence[int], tile: Sequence[int], th: int, tw: int, stripe: int,
                  rows: Tuple[int, int] = None) -> List[Tuple[int, int, int, int]]:
    """The blocks that the kernel's CTA for one (slot, stripe) reads, as
    (first block row, end, first block column, end) per component of the
    slot's image ([] when it reads none: a zero or caller slot, or a stripe
    past the image). ``comps`` the batch's (n, 8) descriptors, ``image``
    and ``tile`` the slot's rows; ``rows`` a band of the tile's rows
    (default all of them)."""
    kind, _, tx, ty = tile
    y0, y1 = rows or (0, th)
    x0 = stripe * STRIPE_W
    xa, xb = tx + x0, min(tx + min(x0 + STRIPE_W, tw), image[2])
    ya, yb = ty + y0, min(ty + y1, image[3])
    if kind != TILE_DECODED or xa >= xb or ya >= yb:
        return []
    out = []
    for c in range(image[0]):
        s = int(comps[image[1] + c][5])
        mode, hf, vf, dw, dh = image[5 + 5 * c:10 + 5 * c]
        fh, fv = _fancy(mode)
        c0, c1 = _span(fh, hf, dw, xa, xb)
        r0, r1 = _span(fv, vf, dh, ya, yb)
        out.append((r0 // s, (r1 - 1) // s + 1, c0 // s, (c1 - 1) // s + 1))
    return out


def idct_batch_plain(coef: torch.Tensor, qt: torch.Tensor, comps: torch.Tensor,
                     plane_bytes: int) -> torch.Tensor:
    """The IDCT half of ``decode_batch_plain``: every component's blocks ->
    its plane of (blocks_h * S, blocks_w * S) samples, all planes in one
    uint8 buffer of ``plane_bytes``."""
    planes = torch.zeros(plane_bytes, dtype=torch.uint8, device=coef.device)
    for coef_off, plane_off, bw, bh, k, s, qt_off, pw in comps.tolist():
        blocks = coef[coef_off:coef_off + bw * bh * k * k].reshape(-1, k, k)
        px = idct_plain(blocks, qt[qt_off:qt_off + 64].reshape(8, 8), s)
        plane = px.reshape(bh, bw, s, s).permute(0, 2, 1, 3).reshape(bh * s, bw * s)
        planes[plane_off:plane_off + bh * s * pw] = plane.reshape(-1).to(torch.uint8)
    return planes


def image_rgb_plain(planes: torch.Tensor, comps: torch.Tensor, image: Sequence[int]) -> torch.Tensor:
    """One image's (out_h, out_w, 3) uint8 pixels from its planes:
    upsampling, crop, colour conversion."""
    ncomp, first, w, h, color = image[:5]
    out = []
    for c in range(ncomp):
        _, plane_off, bw, bh, _, s, _, pw = comps[first + c].tolist()
        mode, hf, vf, dw, dh = image[5 + 5 * c:10 + 5 * c]
        plane = planes[plane_off:plane_off + bh * s * pw].reshape(bh * s, pw)[:dh, :dw].to(torch.int32)
        out.append(upsample_plain(plane, mode, hf, vf)[:h, :w])
    if color == COLOR_GREY:
        return out[0].to(torch.uint8).unsqueeze(-1).expand(h, w, 3).contiguous()
    if color == COLOR_RGB:  # jdcolor.c's rgb_rgb_convert: the components as they are
        return torch.stack(out, -1).to(torch.uint8)
    return ycc_to_rgb_plain(*out)


def color_batch_plain(planes: torch.Tensor, comps: torch.Tensor, images: torch.Tensor,
                      tiles: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The colour half of ``decode_batch_plain``: fills ``out`` (n_slots,
    TH, TW, 3) uint8 in place from the planes, each decoded slot with its
    tile of its image (zero past the image), zero slots with zeros;
    TILE_CALLER slots stay as they are."""
    th, tw = out.shape[1:3]
    rgb = {}
    for slot, (kind, img, x, y) in enumerate(tiles.tolist()):
        if kind == TILE_CALLER:
            continue
        out[slot] = 0
        if kind == TILE_ZERO:
            continue
        if img not in rgb:
            rgb[img] = image_rgb_plain(planes, comps, images[img].tolist())
        crop = rgb[img][y:y + th, x:x + tw]
        out[slot, :crop.shape[0], :crop.shape[1]] = crop
    return out


def decode_batch_plain(coef: torch.Tensor, qt: torch.Tensor, comps: torch.Tensor, images: torch.Tensor,
                       tiles: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``jpeg_decode_kernel``: the batch's coefficients ->
    ``out`` (n_slots, TH, TW, 3) uint8, in place, through whole planes (the
    kernel keeps none in device memory)."""
    plane_bytes = max((po + bh * s * pw for _, po, _, bh, _, s, _, pw in comps.tolist()), default=0)
    planes = idct_batch_plain(coef, qt, comps, plane_bytes)
    return color_batch_plain(planes, comps, images, tiles, out)


# ---------------------------------------------------------------- whole image

def tile_grid(width: int, height: int, eff: int) -> List[Tuple[int, int]]:
    """Tile origins (x, y) in decoded pixels, x-major: a side no longer
    than a tile gives one (zero-padded) tile, a longer side its whole
    tiles, the ragged edge dropped (the grid of the JAX package's
    tileloader.cc)."""
    nx = 1 if width <= eff else width // eff
    ny = 1 if height <= eff else height // eff
    return [(tx * eff, ty * eff) for tx in range(nx) for ty in range(ny)]


def reconstruct_plain(image: EntropyImage, out_tile: int = 0):
    """The image's RGB pixels from its coefficients: (out_height,
    out_width, 3) uint8. With out_tile > 0, the tiles of the hard grid
    instead: ((N, out_tile, out_tile, 3) uint8 zero-padded, [(x, y)] tile
    origins in decoded pixels), in ``tile_grid``'s order."""
    w, h = image.out_width, image.out_height
    offs = tile_grid(w, h, out_tile) if out_tile else [(0, 0)]
    packed, lay = describe_batch([image.meta], [0], [(TILE_DECODED, 0, x, y) for x, y in offs])
    qt, comps, images, tiles = unpack_batch(torch.from_numpy(packed), lay)
    shape = (out_tile, out_tile) if out_tile else (h, w)
    out = decode_batch_plain(image.coef, qt, comps, images, tiles,
                             torch.empty((len(offs), *shape, 3), dtype=torch.uint8))
    return (out, offs) if out_tile else out[0]
