"""Helpers for the port's tests that compare with the JAX package's native
loader: build native/libaquatile.so once across pytest-xdist workers, and
write JPEGs with scan scripts that PIL cannot (libjpeg's own encoder).

``jax_native_loader`` runs ``make -C native`` under a file lock in the
temp directory (the workers of one run share the output) and then reloads
``aquaculture_tpu.data.native_loader``: that module caches a missing
library for the life of the process, and tests/test_decode_scale.py asks
for it at import, before anything has built it.
"""

from __future__ import annotations

import fcntl
import importlib
import os
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parent.parent


@contextmanager
def _locked(name: str):
    with open(os.path.join(tempfile.gettempdir(), name), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def jax_native_loader():
    """The JAX package's native loader module with native/libaquatile.so
    built (make, as tests/test_native.py builds it), or None if it does
    not build or load here."""
    with _locked("aquaculture_libaquatile.lock"):
        if not (REPO / "native" / "libaquatile.so").exists():
            subprocess.run(["make", "-C", str(REPO / "native")], capture_output=True)
    from aquaculture_tpu.data import native_loader as jn

    jn = importlib.reload(jn)
    return jn if jn.available() else None


# A JPEG writer over libjpeg: raw RGB/grey/CMYK bytes in, and a scan script
# by name: "spectral" (progressive by spectral selection alone), "simple"
# (jpeg_simple_progression: with successive approximation), "multiscan"
# (sequential, one scan per component), "unfinished" (progressive whose DC
# and AC scans stop short of their last bits), "unfinished_ac" (the DC
# whole, the AC scans short of their last bit), "dc_only" (one DC scan and
# nothing after: an interrupted download), "rgb" (one sequential scan coded
# as RGB, jpeg_set_colorspace(JCS_RGB): Adobe transform 0), "plain" (one
# sequential scan); an "arith_" prefix codes any of them arithmetically
# ("arith" alone: "arith_plain").
WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
/* writer RAW W H COMPONENTS OUT MODE QUALITY RESTART_ROWS LUMA_H LUMA_V */
int main(int argc, char** argv) {
  if (argc < 11) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  const char* mode = argv[6];
  const int arith = strncmp(mode, "arith", 5) == 0;
  if (arith) mode = mode[5] == '_' ? mode + 6 : "plain";
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 3;
  unsigned char* px = (unsigned char*)malloc((size_t)w * h * nc);
  if (fread(px, 1, (size_t)w * h * nc, f) != (size_t)w * h * nc) return 3;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[5], "wb");
  if (!o) return 4;
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  if (!strcmp(mode, "rgb")) jpeg_set_colorspace(&c, JCS_RGB);
  jpeg_set_quality(&c, atoi(argv[7]), TRUE);
  c.restart_in_rows = atoi(argv[8]);
  c.arith_code = arith;
  if (nc == 3) {
    c.comp_info[0].h_samp_factor = atoi(argv[9]);
    c.comp_info[0].v_samp_factor = atoi(argv[10]);
  }
  static jpeg_scan_info s[16];
  int n = 0;
#define SCAN1(ci, ss, se, ah, al) \
  do { s[n].comps_in_scan = 1; s[n].component_index[0] = ci; \
       s[n].Ss = ss; s[n].Se = se; s[n].Ah = ah; s[n].Al = al; ++n; } while (0)
  const int dc_al = !strcmp(mode, "unfinished"), ac_al = !strcmp(mode, "unfinished") || !strcmp(mode, "unfinished_ac");
  if (!strcmp(mode, "spectral") || !strncmp(mode, "unfinished", 10) || !strcmp(mode, "dc_only")) {
    s[n].comps_in_scan = nc;
    for (int i = 0; i < nc; ++i) s[n].component_index[i] = i;
    s[n].Ss = s[n].Se = s[n].Ah = 0;
    s[n].Al = dc_al;
    ++n;
    if (strcmp(mode, "dc_only")) {
      SCAN1(0, 1, 5, 0, 2 * ac_al);
      for (int i = nc - 1; i >= 1; --i) SCAN1(i, 1, 63, 0, ac_al);
      SCAN1(0, 6, 63, 0, 2 * ac_al);
    }
  } else if (!strcmp(mode, "multiscan")) {
    for (int i = 0; i < nc; ++i) SCAN1(i, 0, 63, 0, 0);
  } else if (!strcmp(mode, "simple")) {
    jpeg_simple_progression(&c);
  }
  if (n) {
    c.scan_info = s;
    c.num_scans = n;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  jpeg_destroy_compress(&c);
  return 0;
}
"""


def libjpeg_writer(d: Path) -> Optional[str]:
    """``WRITER`` built with the compiler and libjpeg that native/ builds
    with, into ``d``; None if it does not build here."""
    src, exe = d / "jpeg_writer.c", d / "jpeg_writer"
    src.write_text(WRITER)
    proc = subprocess.run(["cc", "-O1", "-o", str(exe), str(src), "-ljpeg"], capture_output=True)
    return str(exe) if proc.returncode == 0 else None


def write_jpeg(writer: str, img: np.ndarray, path: Path, mode: str, quality: int = 90, restart_rows: int = 0,
               luma: tuple = (2, 2)) -> str:
    """``img`` (H, W), (H, W, 3) or (H, W, 4 CMYK) uint8 -> a JPEG at
    ``path`` by ``WRITER``'s ``mode``, luma sampled ``luma`` (h, v)."""
    raw = path.with_suffix(".raw")
    np.ascontiguousarray(img).tofile(raw)
    nc = 1 if img.ndim == 2 else img.shape[2]
    subprocess.run([writer, str(raw), str(img.shape[1]), str(img.shape[0]), str(nc), str(path), mode,
                    str(quality), str(restart_rows), str(luma[0]), str(luma[1])], check=True)
    raw.unlink()
    return str(path)


# The JPEGs that chip_smoke.py's feed phase reads from tests/data/torch_jpeg/
# (the card's machine has no libjpeg to write them), each by ``WRITER``:
# name -> (mode, restart rows, luma sampling (h, v)). Each is one
# ``fixture_image`` of FIXTURE_SIZE at quality 90 (seed: its place here).
FEED_FIXTURES = {
    "arith_restart": ("arith", 1, (2, 2)),          # arithmetic sequential, a restart every MCU row
    "arith_progressive": ("arith_simple", 0, (2, 2)),  # arithmetic, jpeg_simple_progression
    "interrupted": ("unfinished", 0, (2, 2)),       # DC and AC short of their last bits: smoothed
    "interrupted_ac": ("unfinished_ac", 0, (2, 1)),  # the AC alone short: smoothed, DC kept
    "dc_only": ("dc_only", 0, (2, 2)),              # the DC scan alone: DC and AC 1..9 estimated
    "luma31": ("plain", 0, (3, 1)),                 # box upsampling by 3 across
    "luma14": ("plain", 0, (1, 4)),                 # box upsampling by 4 down
}
FIXTURE_SIZE = (256, 384)  # (height, width)
FIXTURES = REPO / "tests" / "data" / "torch_jpeg"


def fixture_image(seed: int, h: int = FIXTURE_SIZE[0], w: int = FIXTURE_SIZE[1]) -> np.ndarray:
    """A seeded aerial-like (h, w, 3) uint8 image: a smooth field (bilinear
    up from a coarse grid), fine texture and a bright rectangle."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 255, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    img = img + rng.integers(-10, 11, (h, w, 3), dtype=np.int16)
    img[h // 4:h // 2, w // 3:w // 2] = 235
    return np.clip(img, 0, 255).astype(np.uint8)


def write_feed_fixtures(writer: str, d: Path) -> dict:
    """``FEED_FIXTURES`` written into ``d``: name -> path."""
    out = {}
    for i, (name, (mode, restart_rows, luma)) in enumerate(FEED_FIXTURES.items()):
        out[name] = write_jpeg(writer, fixture_image(i), d / f"{name}.jpg", mode, 90, restart_rows, luma)
    return out
