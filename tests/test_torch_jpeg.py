"""The port's JPEG decoder (csrc/jpeg_entropy.cc + data/jpeg_plain.py)
against PIL's and the JAX package's libjpeg-turbo decodes.

Tolerance 0 throughout: the host entropy decode followed by the kernel's
plain version gives PIL's bytes at 8/8 and the JAX native loader's
(libjpeg-turbo 2.1 through native/libaquatile.so) at every N/8, where
libjpeg-turbo's scaled IDCTs (jidctred.c's 1x1, 2x2, 4x4 and jidctint.c's
3x3 .. 14x14; 4:2:0 chroma takes twice the luma's size) replace a resize.
The cases cover 4:2:0 at three qualities, 4:4:4, 4:2:2, 4:4:0, 4:1:1
(box upsampling by 4), RGB-coded files (Adobe transform 0: the components
copied, no YCbCr), greyscale, sizes that are not multiples of the MCU,
and restart intervals; one-block cosine images hold each scaled IDCT to the
coefficients libjpeg's reads. The kernel wrapper takes the plain version
on CPU tensors and nothing else; the kernel itself is held to the plain
version on the card by chip_smoke.py. Here its stripe arithmetic is: the
blocks that ``stripe_blocks`` names for a CTA are all that its pixels
depend on.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp, native_loader
from torch_jax_native import jax_native_loader

REPO = Path(__file__).resolve().parent.parent
SCALES = tuple(range(1, 9))

# (name, (height, width), PIL save options; "gray" for one component,
# "440" and "411" for 4:4:0 and 4:1:1 through OpenCV, which PIL does not
# write)
CASES = (
    ("q75_420", (96, 128), dict(quality=75)),
    ("q90_420", (128, 128), dict(quality=90)),
    ("q95_420", (128, 96), dict(quality=95)),
    ("q90_444", (96, 96), dict(quality=90, subsampling=0)),
    ("q90_422", (96, 112), dict(quality=90, subsampling=1)),
    ("gray", (72, 90), "gray"),
    ("partial_mcu", (75, 100), dict(quality=90)),          # 1000 x 750 at a tenth
    ("partial_422", (37, 53), dict(quality=85, subsampling=1)),
    ("restart_blocks", (96, 128), dict(quality=90, restart_marker_blocks=5)),
    ("restart_rows", (70, 90), dict(quality=60, subsampling=0, restart_marker_rows=1)),
    ("q90_440", (200, 333), "440"),                          # H1V2 chroma
    ("q90_411", (96, 136), "411"),                           # luma 4x1: chroma boxed by 4 across
    ("rgb_444", (88, 120), dict(quality=90, keep_rgb=True, subsampling=0)),  # RGB-coded
)
NAMES = [c[0] for c in CASES]


def aerial(rng, h, w):
    coarse = rng.integers(0, 255, (h // 16 + 2, w // 16 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = img + rng.integers(-12, 13, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Seeded images written by PIL, and the JAX native loader
    (``jax_native_loader``: None if it does not build here)."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(21)
    paths = {}
    for name, (h, w), kw in CASES:
        img = aerial(rng, h, w)
        p = d / f"{name}.jpg"
        if kw == "gray":
            Image.fromarray(img[..., 0]).save(p, quality=90)
        elif kw in ("440", "411"):
            factor = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440 if kw == "440" else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
            cv2.imwrite(str(p), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                 factor])
        else:
            Image.fromarray(img).save(p, **kw)
        paths[name] = str(p)
    return paths, jax_native_loader()


def _jax(jpegs):
    if jpegs[1] is None:
        pytest.skip("native/libaquatile.so does not build here")
    return jpegs[1]


@pytest.mark.parametrize("name", NAMES)
def test_entropy_decode_and_plain_equal_pil_at_full_size(jpegs, name):
    path = jpegs[0][name]
    image = native_loader.entropy_decode(path, 8)
    assert image is not None and image.meta[jp.M_KIND] == jp.KIND_BASELINE
    got = jp.reconstruct_plain(image).numpy()
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_equal_jax_native_loader_at_8_8_and_5_8(jpegs, name):
    jn = _jax(jpegs)
    path = jpegs[0][name]
    np.testing.assert_array_equal(native_loader.decode_image(path, "cpu").numpy(), jn.decode_image(path))
    w, h = Image.open(path).size
    target = max(w, h) * 5 // 8  # native_loader.scale_for picks 5/8 for it, as tileloader.cc does
    assert native_loader.scale_for(w, h, target) == 5
    got = native_loader.decode_image_scaled(path, target, "cpu").numpy()
    want = jn.decode_image_scaled(path, target)
    assert got.shape == want.shape == ((h * 5 + 7) // 8, (w * 5 + 7) // 8, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [n for n in SCALES if n not in (5, 8)])
@pytest.mark.parametrize("name", NAMES)
def test_equal_jax_native_loader_at_every_other_scale(jpegs, name, scale):
    """1/8, 2/8, 3/8, 4/8, 6/8 and 7/8 (the 1x1, 2x2, 4x4 IDCTs of
    jidctred.c, the 3x3, 6x6, 7x7 of jidctint.c, 4:2:0 chroma at 6x6 ..
    14x14, box upsampling at 1/8): the JAX native loader's bytes."""
    jn = _jax(jpegs)
    path = jpegs[0][name]
    w, h = Image.open(path).size
    target = max(w, h) * scale // 8
    assert native_loader.scale_for(w, h, target) == scale
    got = native_loader.decode_image_scaled(path, target, "cpu").numpy()
    want = jn.decode_image_scaled(path, target)
    assert got.shape == want.shape == (-(-h * scale // 8), -(-w * scale // 8), 3)
    np.testing.assert_array_equal(got, want)


# The layout probe gives at each N/8: (luma, chroma) IDCT sizes and the
# chroma's upsampling per sampling (jdmaster.c's and jdsample.c's choices)
LAYOUT = {
    "q90_420": {1: (1, 2, jp.UP_FULL), 2: (2, 4, jp.UP_FULL), 3: (3, 6, jp.UP_FULL), 4: (4, 8, jp.UP_FULL),
                5: (5, 10, jp.UP_FULL), 6: (6, 12, jp.UP_FULL), 7: (7, 14, jp.UP_FULL), 8: (8, 8, jp.UP_H2V2)},
    "q90_422": {1: (1, 1, jp.UP_BOX), **{n: (n, n, jp.UP_H2V1) for n in range(2, 9)}},
    "q90_440": {1: (1, 1, jp.UP_BOX), **{n: (n, n, jp.UP_H1V2) for n in range(2, 9)}},
    "q90_444": {n: (n, n, jp.UP_FULL) for n in SCALES},
    "q90_411": {n: (n, n, jp.UP_BOX) for n in SCALES},
}


@pytest.mark.parametrize("scale", SCALES)
def test_layout_at_every_scale_is_libjpegs(jpegs, scale):
    """Each component's IDCT size, kept coefficients and upsampling at
    scale/8, as libjpeg-turbo's jpeg_calc_output_dimensions and jdsample.c
    choose them; the kept square is what the IDCT reads (5 x 5 for
    jidctred.c's 2x2, 7 x 7 for its 4x4). The MCU height is a batch's band
    unit."""
    for name, sizes in LAYOUT.items():
        m = native_loader.probe(jpegs[0][name], scale)
        comps = jp.components_of(m)
        luma, chroma, mode = sizes[scale]
        assert [c.size for c in comps] == [luma, chroma, chroma], name
        assert [c.kept for c in comps] == [{2: 5, 4: 7}.get(s, min(s, 8)) for s in (luma, chroma, chroma)]
        assert [jp.upsample_mode(c, m)[0] for c in comps] == [jp.UP_FULL, mode, mode], name
        rows = max(c.size * jp.upsample_mode(c, m)[2] for c in comps)  # IDCT rows x vertical factor
        want = 2 * scale if name in ("q90_420", "q90_440") else scale
        assert jp.describe_batch([m], [0], [])[1].band_unit == rows == want, name
        assert m[jp.M_COLOR] == jp.COLOR_YCC, name
    m = native_loader.probe(jpegs[0]["q90_411"], scale)
    assert [jp.upsample_mode(c, m)[1:] for c in jp.components_of(m)] == [(1, 1), (4, 1), (4, 1)]
    assert native_loader.probe(jpegs[0]["rgb_444"], scale)[jp.M_COLOR] == jp.COLOR_RGB


def _cosine_block(u: int, v: int, n: int = 8) -> np.ndarray:
    """An n x n block of 128 + 60 cos((2x + 1) u pi / 16) cos((2y + 1) v
    pi / 16), tiled from one 8 x 8 period."""
    x = np.arange(n) % 8
    cu = np.cos((2 * x + 1) * u * np.pi / 16)
    cv = np.cos((2 * x + 1) * v * np.pi / 16)
    return np.clip(np.round(128 + 60 * np.outer(cv, cu)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def cosines(tmp_path_factory, jpegs):
    """One-block JPEGs at quality 100 (quantisation 1): grey 8 x 8 with a
    horizontal cosine of frequency u = 0..7 (or vertical, v), and one
    16 x 16 4:2:0 MCU whose chroma carries the cosine."""
    d = tmp_path_factory.mktemp("cosines")
    paths = {}
    for f in range(8):
        for axis, (u, v) in (("h", (f, 0)), ("v", (0, f))):
            p = d / f"grey_{axis}{f}.jpg"
            Image.fromarray(_cosine_block(u, v)).save(p, quality=100)
            paths[("grey", axis, f)] = str(p)
        cb = np.kron(_cosine_block(f, 0), np.ones((2, 2), np.uint8))
        ycc = np.stack([np.full((16, 16), 128, np.uint8), cb, 255 - cb], -1)
        p = d / f"chroma_h{f}.jpg"
        Image.fromarray(ycc, "YCbCr").save(p, quality=100)
        paths[("chroma", "h", f)] = str(p)
    return paths


@pytest.mark.parametrize("scale", SCALES)
def test_scaled_idcts_equal_jax_on_one_block_cosines(jpegs, cosines, scale):
    """Every scaled IDCT against the JAX loader, one block at a time: grey
    blocks take the luma size (1 .. 8), the 4:2:0 MCU's chroma twice it
    (10x10, 12x12, 14x14 at 5/8 .. 7/8). libjpeg's 4x4 and 2x2 read past
    the top-left square: at 4/8 frequencies 5 and 7 move the output and 4
    does not; at 2/8 3, 5 and 7 do and 2, 4 do not; at 3/8 frequency 3
    does not (jidctint.c's 3x3 reads 0-2)."""
    jn = _jax(jpegs)
    flat = {}
    for key, path in cosines.items():
        kind = key[0]
        target = (8 if kind == "grey" else 16) * scale // 8
        got = native_loader.decode_image_scaled(path, target, "cpu").numpy()
        want = jn.decode_image_scaled(path, target) if scale < 8 else jn.decode_image(path)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=str(key))
        if kind == "grey":
            line = want[0, :, 0] if key[1] == "h" else want[:, 0, 0]
            flat[key[1:]] = int(line.max()) - int(line.min()) == 0
    reads = {1: {0}, 2: {0, 1, 3, 5, 7}, 3: {0, 1, 2}, 4: {0, 1, 2, 3, 5, 6, 7}}
    if scale in reads:
        assert set(jp.kept_index(scale)) == reads[scale]  # the kept square is what moves the output
    for axis in ("h", "v"):
        for f in range(1, 8):
            if scale in reads:
                assert flat[(axis, f)] == (f not in reads[scale]), (axis, f)


def test_scaled_chroma_takes_the_10x10_idct(jpegs):
    """4:2:0 at 5/8: luma 5x5 keeping 5 x 5 coefficients, chroma 10x10
    keeping all 64 and no upsampling (libjpeg-turbo's jdmaster.c choice);
    4:2:2 at 5/8 keeps 5x5 chroma and upsamples it h2v1."""
    m = native_loader.probe(jpegs[0]["q90_420"], 5)
    comps = jp.components_of(m)
    assert [(c.size, c.kept) for c in comps] == [(5, 5), (10, 8), (10, 8)]
    assert [jp.upsample_mode(c, m)[0] for c in comps] == [jp.UP_FULL] * 3
    m = native_loader.probe(jpegs[0]["q90_422"], 5)
    assert [jp.upsample_mode(c, m)[0] for c in jp.components_of(m)] == [jp.UP_FULL, jp.UP_H2V1, jp.UP_H2V1]
    m = native_loader.probe(jpegs[0]["q90_420"], 8)
    assert [jp.upsample_mode(c, m)[0] for c in jp.components_of(m)] == [jp.UP_FULL, jp.UP_H2V2, jp.UP_H2V2]


def _fancy_loops(x, h, v):
    """jdsample.c's h2v1 / h1v2 / h2v2 fancy loops, element by element."""
    x = np.asarray(x, np.int64)
    rows, cols = x.shape
    out = np.zeros((rows * v, cols * h), np.int64)
    for r in range(rows):
        for vv in range(v):
            near = x[r]
            if v == 2:
                far = x[max(r - 1, 0)] if vv == 0 else x[min(r + 1, rows - 1)]
            for c in range(cols):
                if v == 1:
                    t = 3 * near[c]
                    out[r, 2 * c] = (t + near[max(c - 1, 0)] + 1) >> 2
                    out[r, 2 * c + 1] = (t + near[min(c + 1, cols - 1)] + 2) >> 2
                elif h == 1:
                    out[2 * r + vv, c] = (3 * near[c] + far[c] + (1 if vv == 0 else 2)) >> 2
                else:
                    cs = [3 * near[i] + far[i] for i in range(cols)]
                    out[2 * r + vv, 2 * c] = (3 * cs[c] + cs[max(c - 1, 0)] + 8) >> 4
                    out[2 * r + vv, 2 * c + 1] = (3 * cs[c] + cs[min(c + 1, cols - 1)] + 7) >> 4
    return out


@pytest.mark.parametrize("h,v", [(2, 1), (1, 2), (2, 2)])
def test_upsample_fancy_plain_equals_jdsample_loops(h, v):
    x = np.random.default_rng(h * 10 + v).integers(0, 256, (5, 7))
    got = jp.upsample_fancy_plain(torch.from_numpy(x).to(torch.int32), h, v).numpy()
    np.testing.assert_array_equal(got, _fancy_loops(x, h, v))


def test_ycc_to_rgb_plain_equals_jdcolor_tables():
    """Every (Cb, Cr) pair at three luma values against jdcolor.c's
    build_ycc_rgb_table arithmetic."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    x_cb, x_cr = cb - 128, cr - 128
    r_tab = (91881 * x_cr + 32768) >> 16
    b_tab = (116130 * x_cb + 32768) >> 16
    g_tab = (-22554 * x_cb + 32768 - 46802 * x_cr) >> 16
    for y in (0, 117, 255):
        yy = np.full_like(cb, y)
        want = np.clip(np.stack([yy + r_tab, yy + g_tab, yy + b_tab], -1), 0, 255).astype(np.uint8)
        t = lambda a: torch.from_numpy(a).to(torch.int32)
        np.testing.assert_array_equal(jp.ycc_to_rgb_plain(t(yy), t(cb), t(cr)).numpy(), want)


def test_range_limit_is_libjpegs_table():
    x = torch.arange(-2048, 2048, dtype=torch.int32)
    t = np.arange(-2048, 2048) & 1023
    want = np.clip(np.where(t >= 512, t - 1024, t) + 128, 0, 255)
    np.testing.assert_array_equal(jp.range_limit(x).numpy(), want)


def test_dc_only_blocks_are_flat():
    q = torch.ones((8, 8), dtype=torch.int32)
    for size in jp.IDCT_SIZES:
        k = jp.kept(size)
        coeffs = torch.zeros((3, k, k), dtype=torch.int32)
        coeffs[:, 0, 0] = torch.tensor([-1024, 0, 800])
        px = jp.idct_plain(coeffs, q, size)
        assert px.shape == (3, size, size)
        assert [int(v) for v in px.reshape(3, -1).unique(dim=1).reshape(-1)] == [0, 128, 228]


def test_idct_plain_refuses_what_libjpeg_has_not(jpegs):
    """A size libjpeg has no scaled IDCT for (9 would need scale 9/8), or
    a block that is not the kept square of its size, raises."""
    with pytest.raises(ValueError, match="no scaled IDCT of size 9"):
        jp.idct_plain(torch.zeros((1, 8, 8), dtype=torch.int32), torch.ones((8, 8)), 9)
    with pytest.raises(ValueError, match="size 4 takes 7 x 7"):
        jp.idct_plain(torch.zeros((1, 8, 8), dtype=torch.int32), torch.ones((8, 8)), 4)
    assert [jp.kept(s) for s in jp.IDCT_SIZES] == [1, 5, 3, 7, 5, 6, 7, 8, 8, 8, 8]
    assert jp.kept_index(2) == (0, 1, 3, 5, 7) and jp.kept_index(4) == (0, 1, 2, 3, 5, 6, 7)


def test_kernel_wrappers_take_the_plain_versions_on_cpu_tensors(jpegs, monkeypatch):
    """On CPU tensors ``jpeg_decode`` runs its plain version (the kernel
    library is never built); on any other device it raises."""
    monkeypatch.setattr(jpeg_cuda, "_lib", None)
    images = [native_loader.entropy_decode(jpegs[0][n], 8) for n in ("q90_420", "gray", "q90_422")]
    offs = np.cumsum([0] + [im.coef.numel() for im in images[:-1]]).tolist()
    tiles = [(jp.TILE_DECODED, i, 0, 0) for i in range(3)] + [(jp.TILE_ZERO, 0, 0, 0), (jp.TILE_CALLER, 0, 0, 0)]
    packed, lay = jp.describe_batch([im.meta for im in images], offs, tiles)
    qt, comps, imgs, tt = jp.unpack_batch(torch.from_numpy(packed), lay)
    coef = torch.cat([im.coef for im in images])
    launches = jpeg_cuda.decode_launches
    out = jpeg_cuda.jpeg_decode(coef, qt, comps, imgs, tt, torch.full((5, 64, 64, 3), 9, dtype=torch.uint8))
    planes = jp.idct_batch_plain(coef, qt, comps, lay.plane_bytes)
    want = jp.color_batch_plain(planes, comps, imgs, tt, torch.full((5, 64, 64, 3), 9, dtype=torch.uint8))
    assert torch.equal(out, want)
    for i, name in enumerate(("q90_420", "gray", "q90_422")):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(Image.open(jpegs[0][name]).convert("RGB"))[:64, :64])
    assert (out[3] == 0).all() and (out[4] == 9).all()  # zero slot, caller slot untouched
    assert jpeg_cuda._lib is None and jpeg_cuda.decode_launches == launches
    meta = [t.to("meta") for t in (coef, qt, comps, imgs, tt)]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        jpeg_cuda.jpeg_decode(*meta, torch.empty((5, 64, 64, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(TypeError, match="int16"):
        jpeg_cuda.jpeg_decode(coef.int(), qt, comps, imgs, tt, out)
    with pytest.raises(ValueError, match="out must be"):
        jpeg_cuda.jpeg_decode(coef, qt, comps, imgs, tt, out[:4])


def _stripe_cases():
    return [(name, scale) for name in NAMES for scale in SCALES] + [("grid_2x2", n) for n in SCALES]


@pytest.mark.parametrize("name,scale", _stripe_cases())
def test_stripe_blocks_are_all_a_cta_reads(jpegs, name, scale):
    """For every CTA of the kernel's grid (stripe, slot, band): fill every
    coefficient outside the blocks ``stripe_blocks`` names with seeded
    garbage; the CTA's pixels of the plain decode stay equal to the
    untouched decode's. Whole images, and a 2 x 2 tile grid of the 128 px
    4:2:0 case (tiles of 64 px at 8/8, 40 at 5/8). Every named span fits
    the kernel's ring."""
    grid = name == "grid_2x2"
    image = native_loader.entropy_decode(jpegs[0]["q90_420" if grid else name], scale)
    w, h = image.out_width, image.out_height
    eff = 8 * scale if grid else 0
    origins = jp.tile_grid(w, h, eff) if grid else [(0, 0)]
    assert len(origins) == (4 if grid else 1)
    tiles = [(jp.TILE_DECODED, 0, x, y) for x, y in origins]
    packed, lay = jp.describe_batch([image.meta], [0], tiles)
    qt, comps, imgs, tt = jp.unpack_batch(torch.from_numpy(packed), lay)
    th, tw = (eff, eff) if grid else (h, w)
    shape = (len(tiles), th, tw, 3)
    want = jp.decode_batch_plain(image.coef, qt, comps, imgs, tt, torch.empty(shape, dtype=torch.uint8))
    stripes, band_rows = jp.decode_grid(len(tiles), th, tw, lay)
    cs = comps.tolist()
    rng = np.random.default_rng(scale * 100 + len(name))
    checked = 0
    for slot, tile in enumerate(tt.tolist()):
        for stripe in range(stripes):
            for y0 in range(0, th, band_rows):
                rows = (y0, min(y0 + band_rows, th))
                spans = jp.stripe_blocks(cs, imgs[0].tolist(), tile, th, tw, stripe, rows)
                assert len(spans) == len(cs)
                keep = torch.zeros(image.coef.numel(), dtype=torch.bool)
                for c, ((coef_off, _, bw, bh, k, s, _, _), (r0, r1, c0, c1)) in enumerate(zip(cs, spans)):
                    assert 0 <= r0 < r1 <= bh and 0 <= c0 < c1 <= bw
                    # the ring row: the blocks, from the pad that puts the
                    # stripe's first pixel on a 16-byte boundary, within the
                    # widest any origin gives, which describe_batch checks
                    mode, hf = imgs[0, 5 + 5 * c].item(), imgs[0, 6 + 5 * c].item()
                    fancy_h = jp._fancy(mode)[0]
                    xa = tile[2] + stripe * jp.STRIPE_W
                    first = xa >> 1 if fancy_h else xa // hf
                    width = c1 * s - (c0 * s - ((c0 * s - first) & 15))
                    room = jp.RING_PITCH - (jp.RING_SLACK if fancy_h else 0)
                    assert width <= jp._ring_row_bytes(fancy_h, hf, s) <= room
                    blocks = keep[coef_off:coef_off + bw * bh * k * k].view(bh, bw, k * k)
                    blocks[r0:r1, c0:c1] = True
                assert not keep.all() or stripes == 1 and th <= band_rows
                garbage = torch.from_numpy(rng.integers(-1024, 1024, keep.numel(), dtype=np.int16))
                coef = torch.where(keep, image.coef, garbage)
                got = jp.decode_batch_plain(coef, qt, comps, imgs, tt, torch.empty(shape, dtype=torch.uint8))
                x0 = stripe * jp.STRIPE_W
                region = (slot, slice(rows[0], rows[1]), slice(x0, x0 + jp.STRIPE_W))
                assert torch.equal(got[region], want[region]), (slot, stripe, rows)
                checked += 1
    assert checked == len(tiles) * stripes * -(-th // band_rows)


def test_describe_batch_refuses_a_ring_row_past_the_pitch(jpegs, monkeypatch):
    """At 5/8, a stripe of 4:2:0 chroma (10x10 blocks at full width) can
    take 14 blocks and a 15 byte pad: 155 bytes of a ring row. A kernel
    whose rows hold fewer would trap on such a stripe, so describe_batch
    refuses the batch before any launch."""
    image = native_loader.entropy_decode(jpegs[0]["q90_420"], 5)
    tiles = [(jp.TILE_DECODED, 0, 0, 0)]
    jp.describe_batch([image.meta], [0], tiles)
    monkeypatch.setattr(jp, "RING_PITCH", 152)
    with pytest.raises(ValueError, match="155 bytes of a ring row; the kernel's rows hold 152"):
        jp.describe_batch([image.meta], [0], tiles)
    monkeypatch.undo()
    grey = native_loader.entropy_decode(jpegs[0]["gray"], 5)
    monkeypatch.setattr(jp, "RING_PITCH", 152)
    jp.describe_batch([grey.meta], [0], tiles)  # 5x5 luma: 150 bytes at most


def test_ring_rows_take_the_14x14_chroma_and_slack_only_for_2x(jpegs, monkeypatch):
    """At 7/8, 4:2:0 chroma takes 14x14 blocks at full width: 11 blocks
    and a 15 byte pad, 169 bytes, within the 176 of a ring row. Only a 2x
    horizontal upsampler reads RING_SLACK bytes past its last sample: 8x8
    blocks upsampled h2v1 take up to 95 bytes and need 103."""
    tiles = [(jp.TILE_DECODED, 0, 0, 0)]
    image = native_loader.entropy_decode(jpegs[0]["q90_420"], 7)
    assert [c.size for c in image.components] == [7, 14, 14] and jp.RING_PITCH == 176
    jp.describe_batch([image.meta], [0], tiles)
    monkeypatch.setattr(jp, "RING_PITCH", 168)
    with pytest.raises(ValueError, match="169 bytes of a ring row; the kernel's rows hold 168"):
        jp.describe_batch([image.meta], [0], tiles)
    # one component of 8x8 blocks upsampled h2v1 (mode, factors, downsampled size)
    image = [1, 0, 256, 64, 0, jp.UP_H2V1, 2, 1, 128, 64]
    monkeypatch.setattr(jp, "RING_PITCH", 103)
    jp._check_ring([8], image)
    monkeypatch.setattr(jp, "RING_PITCH", 102)
    with pytest.raises(ValueError, match="95 bytes of a ring row; the kernel's rows hold 94"):
        jp._check_ring([8], image)
    monkeypatch.setattr(jp, "RING_PITCH", 95)
    jp._check_ring([8], [1, 0, 128, 64, 0, jp.UP_BOX, 2, 1, 64, 64])  # boxed 2x: 87 bytes, no slack


@pytest.mark.parametrize("slots, scale, unit, grid", [(129, 8, 16, (8, 320)), (129, 5, 10, (5, 160)),
                                                      (9, 8, 16, (8, 80)), (129, 4, 8, (4, 64)),
                                                      (129, 1, 2, (1, 4)), (129, 7, 14, (7, 182)),
                                                      (129, 3, 6, (3, 36))])
def test_decode_grid_bands_step_80_rows_at_8_8_and_5_8(slots, scale, unit, grid):
    """Batches of 4:2:0 tiles (b128 and b8, and the zero slot): at 8/8 and
    5/8 bands step BAND_ROWS (1024 px tiles at b128 in 320-row bands, as
    before the other scales), at the other scales the MCU height."""
    tile = 128 * scale
    lay = jp.BatchLayout(n_comps=3, n_images=1, n_slots=slots, plane_bytes=0, band_unit=unit, scale=scale)
    assert jp.decode_grid(slots, tile, tile, lay) == grid
    assert grid[1] % (jp.BAND_ROWS if scale in jp.BAND_ROWS_SCALES else unit) == 0


def test_describe_batch_takes_one_scale(jpegs):
    """The kernel is built per scale: a batch's layout names its one
    scale, and images at two scales are refused before any launch."""
    at = {n: native_loader.entropy_decode(jpegs[0]["q90_420"], n) for n in (8, 3)}
    for n, image in at.items():
        assert jp.describe_batch([image.meta] * 2, [0, 0], [])[1].scale == n
    with pytest.raises(ValueError, match=r"one scale; its images are at \[3, 8\]"):
        jp.describe_batch([at[8].meta, at[3].meta], [0, 0], [])


def test_failed_nvcc_build_raises_with_its_output(tmp_path, monkeypatch):
    """The fused kernel's library builds with nvcc at first use; a failed
    build raises with the compiler's output and nothing falls back."""
    from aquaculture_tpu_torch.ops import nms_cuda

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'jpeg_decode.cu(1): error: stand-in compiler refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    src = tmp_path / "jpeg_decode.cu"
    src.write_text("// a source no build directory holds\n")
    monkeypatch.setattr(nms_cuda, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(nms_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(jpeg_cuda, "SOURCE", str(src))
    monkeypatch.setattr(jpeg_cuda, "_lib", None)
    with pytest.raises(RuntimeError, match="stand-in compiler refused"):
        jpeg_cuda.build()
