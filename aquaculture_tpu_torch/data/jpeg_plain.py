"""Plain PyTorch versions of the JPEG reconstruction kernels.

The port's JPEG decoder runs in two halves: the host entropy decode
(csrc/jpeg_entropy.cc) gives each image's de-zigzagged, still-quantised
int16 coefficients and their metadata; the reconstruction (dequantisation,
integer IDCT, chroma upsampling, YCbCr->RGB, the crop and the tile grid)
runs in the hand-written kernels of csrc/jpeg_decode.cu on the card, and
here, in int32 tensor code, on the CPU. The tests hold this module against
PIL's and the JAX package's libjpeg-turbo decodes byte for byte, and
chip_smoke.py holds the kernels against it with ``torch.equal``.

The arithmetic is libjpeg-turbo's, reproduced exactly, not approximated:
- ``jpeg_idct_islow`` for 8x8 (CONST_BITS 13, PASS1_BITS 2), and the
  scaled ``jpeg_idct_5x5`` and ``jpeg_idct_10x10`` of jidctint.c for 5/8
  (4:2:0 chroma at 5/8 takes the 10x10, so it needs no upsampling), each
  ending in libjpeg's range-limit table (the descaled value's low 10 bits,
  read as signed, plus 128, clamped to 0..255);
- jdsample.c's "fancy" (triangle-filter) h2v1, h1v2 and h2v2 upsampling,
  with its edge replication, and the box upsampling it falls back to;
- jdcolor.c's 16-bit fixed-point YCbCr->RGB tables with ONE_HALF rounding.
The sums fit int32 for every coefficient that an encoder makes from 8-bit
samples (libjpeg computes in 64-bit ``JLONG``); the 8x8 SIMD IDCT of
libjpeg-turbo saturates where the table wraps, which only coefficients out
of that range can tell apart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

# The metadata layout of csrc/jpeg_entropy.cc (one int32 array per image).
META_INTS = 256
M_KIND, M_WIDTH, M_HEIGHT, M_NCOMP, M_MAX_H, M_MAX_V, M_OUT_W, M_OUT_H = range(8)
M_SCALE, M_COLOR, M_RESTART, M_COEFS, M_SOF = range(8, 13)
MC_BASE, MC_INTS, MC_QT = 16, 80, 16   # one component's fields in the metadata
C_H, C_V, C_S, C_K, C_BW, C_BH, C_OFF, C_DW, C_DH = range(9)
KIND_BASELINE, KIND_OTHER_JPEG, KIND_TIFF, KIND_UNREADABLE = range(4)

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
    kept: int       # K: coefficients kept per block side (min(8, S))
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


def _idct5_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One 5-point pass of jpeg_idct_5x5, shifted (pass 1) or not."""
    if second:
        tmp12 = (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
    else:
        tmp12 = z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1))
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
    out = [tmp10 + tmp0, tmp11 + tmp1, tmp12, tmp11 - tmp1, tmp10 - tmp0]
    if second:
        return out
    return [o >> (CONST_BITS - PASS1_BITS) for o in out]


def _idct10_1d(z: List[torch.Tensor], second: bool) -> List[torch.Tensor]:
    """One 10-point pass of jpeg_idct_10x10 (8 inputs), shifted (pass 1)
    or not."""
    if second:
        z3 = (z[0] + (1 << (PASS1_BITS + 2))) * (1 << CONST_BITS)
    else:
        z3 = z[0] * (1 << CONST_BITS) + (1 << (CONST_BITS - PASS1_BITS - 1))
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
    out = [tmp20 + tmp10, tmp21 + tmp11, tmp22 + tmp12, tmp23 + tmp13, tmp24 + tmp14,
           tmp24 - tmp14, tmp23 - tmp13, tmp22 - tmp12, tmp21 - tmp11, tmp20 - tmp10]
    if second:
        return out
    s = CONST_BITS - PASS1_BITS
    return [o if i in (2, 7) else o >> s for i, o in enumerate(out)]


def idct_plain(coeffs: torch.Tensor, qtable: torch.Tensor, size: int) -> torch.Tensor:
    """Dequantise and inverse-DCT blocks: coeffs (N, K, K) quantised
    coefficients (K = min(8, size)), qtable (8, 8) or (N, 8, 8) in natural
    order -> (N, size, size) int32 samples in 0..255. size 8 is
    jpeg_idct_islow, 5 and 10 the scaled IDCTs of libjpeg-turbo."""
    k = min(size, 8)
    if coeffs.shape[-2:] != (k, k):
        raise ValueError(f"size {size} takes {k} x {k} coefficients; got {tuple(coeffs.shape)}")
    q = qtable.to(torch.int32)[..., :k, :k]
    d = coeffs.to(torch.int32) * q
    if size == 8:
        # pass 1 over columns: rows of d are the 1-D inputs
        ws = torch.stack([_descale(o, CONST_BITS - PASS1_BITS) for o in _islow_1d(list(d.unbind(1)))], 1)
        out = [range_limit(_descale(o, CONST_BITS + PASS1_BITS + 3)) for o in _islow_1d(list(ws.unbind(2)))]
    elif size == 5:
        ws = torch.stack(_idct5_1d(list(d.unbind(1)), False), 1)
        out = [range_limit(o >> (CONST_BITS + PASS1_BITS + 3)) for o in _idct5_1d(list(ws.unbind(2)), True)]
    elif size == 10:
        ws = torch.stack(_idct10_1d(list(d.unbind(1)), False), 1)
        out = [range_limit(o >> (CONST_BITS + PASS1_BITS + 3)) for o in _idct10_1d(list(ws.unbind(2)), True)]
    else:
        raise ValueError(f"no IDCT of size {size} in the port: 8/8 and 5/8 only (ROADMAP.md)")
    return torch.stack(out, 2)


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
# A batch for the kernels is a set of images (their coefficients one after
# another in one int16 buffer) and a list of tile slots, described by int32
# arrays (the layout csrc/jpeg_decode.cu reads):
#   comps  (8 per component of each image): coef_off, plane_off, blocks_w,
#          blocks_h, K, S, qt_off, plane_w
#   images (20 per image): ncomp, first comp, out_w, out_h, colour (0 grey,
#          1 YCbCr), then per component: mode, h factor, v factor,
#          downsampled width, downsampled height
#   tiles  (4 per slot): kind (TILE_ZERO, TILE_DECODED, TILE_CALLER),
#          image, x and y origin in decoded pixels
COMP_INTS, IMAGE_INTS, TILE_INTS = 8, 20, 4
TILE_ZERO, TILE_DECODED, TILE_CALLER = 0, 1, 2
IDCT_SIZES = (8, 5, 10)
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class BatchLayout:
    """Sizes of a packed descriptor array (``describe_batch``)."""

    n_comps: int
    n_images: int
    n_slots: int
    plane_bytes: int   # the IDCT's output: every component's plane
    max_blocks: int    # blocks of the largest component


def describe_batch(metas: Sequence[np.ndarray], coef_offsets: Sequence[int],
                   tiles: Sequence[Tuple[int, int, int, int]]) -> Tuple[np.ndarray, BatchLayout]:
    """Pack the descriptors of a batch into one int32 array [qt | comps |
    images | tiles]: ``metas`` the images' metadata, ``coef_offsets`` where
    each image's coefficients start in the batch's int16 buffer, ``tiles``
    one (kind, image, x, y) per slot."""
    n_comps = sum(int(m[M_NCOMP]) for m in metas)
    qt = np.zeros((n_comps, 64), np.int64)
    comps = np.zeros((n_comps, COMP_INTS), np.int64)
    images = np.zeros((len(metas), IMAGE_INTS), np.int64)
    ci = plane_off = max_blocks = 0
    for i, (m, off) in enumerate(zip(metas, coef_offsets)):
        cs = components_of(m)
        images[i, :5] = (len(cs), ci, m[M_OUT_W], m[M_OUT_H], m[M_COLOR])
        for c, comp in enumerate(cs):
            if comp.size not in IDCT_SIZES:
                raise ValueError(f"no {comp.size}x{comp.size} IDCT in the port: it decodes at "
                                 "8/8 and 5/8 only (ROADMAP.md, section 1)")
            mode, hf, vf = upsample_mode(comp, m)
            images[i, 5 + 5 * c:10 + 5 * c] = (mode, hf, vf, comp.width, comp.height)
            pw = comp.blocks_w * comp.size
            comps[ci] = (off + comp.offset, plane_off, comp.blocks_w, comp.blocks_h,
                         comp.kept, comp.size, 64 * ci, pw)
            qt[ci] = comp.qtable.ravel()
            plane_off += comp.blocks_h * comp.size * pw
            max_blocks = max(max_blocks, comp.blocks_w * comp.blocks_h)
            ci += 1
    t = np.asarray(tiles, np.int64).reshape(-1, TILE_INTS)
    packed = np.concatenate([qt.ravel(), comps.ravel(), images.ravel(), t.ravel()])
    if plane_off > _INT32_MAX or (n_comps and comps[:, 0].max() > _INT32_MAX):
        raise ValueError("a batch's coefficients or planes pass 2**31: use a smaller batch")
    return packed.astype(np.int32), BatchLayout(n_comps, len(metas), len(t), plane_off, max_blocks)


def unpack_batch(packed: torch.Tensor, lay: BatchLayout):
    """Views (qt, comps, images, tiles) of a packed descriptor tensor, on
    its device."""
    sizes = (lay.n_comps * 64, lay.n_comps * COMP_INTS, lay.n_images * IMAGE_INTS,
             lay.n_slots * TILE_INTS)
    qt, comps, images, tiles = packed[:sum(sizes)].split(sizes)
    return (qt, comps.view(-1, COMP_INTS), images.view(-1, IMAGE_INTS), tiles.view(-1, TILE_INTS))


def idct_batch_plain(coef: torch.Tensor, qt: torch.Tensor, comps: torch.Tensor,
                     plane_bytes: int) -> torch.Tensor:
    """Plain version of ``jpeg_idct_kernel``: every component's blocks ->
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
    if color == 0:
        return out[0].to(torch.uint8).unsqueeze(-1).expand(h, w, 3).contiguous()
    return ycc_to_rgb_plain(*out)


def color_batch_plain(planes: torch.Tensor, comps: torch.Tensor, images: torch.Tensor,
                      tiles: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``jpeg_color_kernel``: fills ``out`` (n_slots, TH,
    TW, 3) uint8 in place, each decoded slot with its tile of its image
    (zero past the image), zero slots with zeros; TILE_CALLER slots stay
    as they are."""
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
    planes = idct_batch_plain(image.coef, qt, comps, lay.plane_bytes)
    shape = (out_tile, out_tile) if out_tile else (h, w)
    out = color_batch_plain(planes, comps, images, tiles, torch.empty((len(offs), *shape, 3), dtype=torch.uint8))
    return (out, offs) if out_tile else out[0]
