"""The port's JPEG decoder (csrc/jpeg_entropy.cc + data/jpeg_plain.py)
against PIL's and the JAX package's libjpeg-turbo decodes.

Tolerance 0 throughout: the host entropy decode followed by the plain
versions of the two kernels gives PIL's bytes at 8/8 and the JAX native
loader's (libjpeg-turbo 2.1 through native/libaquatile.so) at 8/8 and at
5/8, where libjpeg-turbo's scaled IDCTs (5x5 for luma, 10x10 for 4:2:0
chroma) replace a resize. The cases cover 4:2:0 at three qualities, 4:4:4,
4:2:2, greyscale, sizes that are not multiples of the MCU, and restart
intervals. The kernel wrappers take the plain versions on CPU tensors and
nothing else; the kernels themselves are held to the plain versions on the
card by chip_smoke.py.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from aquaculture_tpu_torch.data import jpeg_cuda, jpeg_plain as jp, native_loader

REPO = Path(__file__).resolve().parent.parent

# (name, (height, width), PIL save options; "gray" for one component)
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
)
NAMES = [c[0] for c in CASES]


def aerial(rng, h, w):
    coarse = rng.integers(0, 255, (h // 16 + 2, w // 16 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = img + rng.integers(-12, 13, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Seeded images written by PIL, and the JAX native loader (built with
    make as tests/test_native.py builds it; None if that build fails)."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(21)
    paths = {}
    for name, (h, w), kw in CASES:
        img = aerial(rng, h, w)
        p = d / f"{name}.jpg"
        if kw == "gray":
            Image.fromarray(img[..., 0]).save(p, quality=90)
        else:
            Image.fromarray(img).save(p, **kw)
        paths[name] = str(p)
    jax_native = None
    if not (REPO / "native" / "libaquatile.so").exists():
        subprocess.run(["make", "-C", str(REPO / "native")], capture_output=True)
    if (REPO / "native" / "libaquatile.so").exists():
        from aquaculture_tpu.data import native_loader as jn

        jax_native = jn if jn.available() else None
    return paths, jax_native


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
    for size in (8, 5, 10):
        k = min(size, 8)
        coeffs = torch.zeros((3, k, k), dtype=torch.int32)
        coeffs[:, 0, 0] = torch.tensor([-1024, 0, 800])
        px = jp.idct_plain(coeffs, q, size)
        assert px.shape == (3, size, size)
        assert [int(v) for v in px.reshape(3, -1).unique(dim=1).reshape(-1)] == [0, 128, 228]


def test_other_scales_and_sizes_name_the_roadmap(jpegs):
    with pytest.raises(ValueError, match="ROADMAP"):
        jp.idct_plain(torch.zeros((1, 4, 4), dtype=torch.int32), torch.ones((8, 8)), 4)
    meta = native_loader.probe(jpegs[0]["q90_420"], 3)  # 3/8: a 3x3 luma IDCT
    with pytest.raises(ValueError, match="ROADMAP"):
        jp.describe_batch([meta], [0], [(jp.TILE_DECODED, 0, 0, 0)])


def test_kernel_wrappers_take_the_plain_versions_on_cpu_tensors(jpegs, monkeypatch):
    """On CPU tensors the wrappers run the plain versions (the kernel
    library is never built); on any other device they raise."""
    monkeypatch.setattr(jpeg_cuda, "_lib", None)
    images = [native_loader.entropy_decode(jpegs[0][n], 8) for n in ("q90_420", "gray", "q90_422")]
    offs = np.cumsum([0] + [im.coef.numel() for im in images[:-1]]).tolist()
    tiles = [(jp.TILE_DECODED, i, 0, 0) for i in range(3)] + [(jp.TILE_ZERO, 0, 0, 0), (jp.TILE_CALLER, 0, 0, 0)]
    packed, lay = jp.describe_batch([im.meta for im in images], offs, tiles)
    qt, comps, imgs, tt = jp.unpack_batch(torch.from_numpy(packed), lay)
    coef = torch.cat([im.coef for im in images])
    planes = jpeg_cuda.jpeg_idct(coef, qt, comps, lay.plane_bytes, lay.max_blocks)
    assert torch.equal(planes, jp.idct_batch_plain(coef, qt, comps, lay.plane_bytes))
    out = jpeg_cuda.jpeg_color(planes, comps, imgs, tt, torch.full((5, 64, 64, 3), 9, dtype=torch.uint8))
    for i, name in enumerate(("q90_420", "gray", "q90_422")):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(Image.open(jpegs[0][name]).convert("RGB"))[:64, :64])
    assert (out[3] == 0).all() and (out[4] == 9).all()  # zero slot, caller slot untouched
    assert jpeg_cuda._lib is None
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        jpeg_cuda.jpeg_idct(coef.to("meta"), qt.to("meta"), comps.to("meta"), lay.plane_bytes, lay.max_blocks)
    with pytest.raises(TypeError, match="int16"):
        jpeg_cuda.jpeg_idct(coef.int(), qt, comps, lay.plane_bytes, lay.max_blocks)


def test_failed_nvcc_build_raises_with_its_output(tmp_path, monkeypatch):
    """The kernel library builds with nvcc at first use; a failed build
    raises with the compiler's output and nothing falls back."""
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
