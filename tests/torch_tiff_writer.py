"""A TIFF writer byte by byte, for the cases PIL cannot write: tiles,
planar files, big-endian and BigTIFF files, Predictor 2 at 16 bits, bit
depths below 8, raw YCbCr in its sampled layout, JPEG tiles with their
tables in JPEGTables, old-style LZW, WebP strips and tiles (PIL's WebP
encoder, or libwebp's advanced API through a small C helper that g++
builds against the system's libwebp: ``webp_encoder``), NeXT and
ThunderScan opcodes. ``libtiff_file`` writes a file through the system's
libtiff itself (ctypes: TIFFSetField, TIFFWriteEncodedStrip/Tile and the
raw writes), for its PixarLog, SGILog, JBIG, LERC, ZSTD and LZMA
encoders; ``jbig_encoder`` builds jbigkit's encoder for BIEs with the
options libtiff does not set; ``lerc_blob`` is libLerc's encoder at the
codec versions libtiff does not write.
Used by tests/test_torch_tiff*.py and chip_smoke.py's feed phase; imports
neither JAX nor the port.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import io
import os
import struct
import subprocess
import tempfile
import zlib

import numpy as np
from PIL import Image

_FORMATS = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 8: "h", 11: "f", 12: "d", 16: "Q"}


def image(seed: int, h: int = 200, w: int = 300, c: int = 3) -> np.ndarray:
    """A seeded image that compresses as imagery does: a smooth field plus
    texture."""
    if c > 4:
        return np.concatenate([image(seed, h, w, 3), image(seed + 1, h, w, c - 3)], -1)
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, c), dtype=np.uint8)
    up = np.asarray(Image.fromarray(coarse.squeeze(-1) if c == 1 else coarse).resize((w, h), Image.BILINEAR))
    img = up.reshape(h, w, c).astype(np.int16) + rng.integers(-12, 13, (h, w, c), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pack_values(typ: int, values, order: str) -> bytes:
    if typ == 5:
        return b"".join(struct.pack(order + "II", a, b) for a, b in values)
    return struct.pack(order + _FORMATS[typ] * len(values), *values)


def tiff_bytes(segments, tags: dict, *, big: bool = False, order: str = "<", tiled: bool = False,
               omit=()) -> bytes:
    """A TIFF of one IFD: the segments' bytes (strips, or tiles when tiled)
    back to back after the header, then the IFD and the tag values that do
    not fit in their entries. tags: {tag: (type, values)}; the offsets and
    byte counts are added here, but for the tags in omit."""
    head = (b"II" if order == "<" else b"MM") + (
        struct.pack(order + "HHHQ", 43, 8, 0, 0) if big else struct.pack(order + "HI", 42, 0))
    data = bytearray(head)
    offsets = []
    for seg in segments:
        offsets.append(len(data))
        data += seg
        if len(data) % 2:
            data += b"\0"
    tags = dict(tags)
    wide = 16 if big else 4
    tags[324 if tiled else 273] = (wide, offsets)
    tags[325 if tiled else 279] = (wide, [len(s) for s in segments])
    entries = sorted((t, v) for t, v in tags.items() if t not in omit)
    inline = 8 if big else 4
    ifd_at = len(data)
    ifd_size = (8 if big else 2) + len(entries) * (20 if big else 12) + (8 if big else 4)
    extra = bytearray()
    body = bytearray(struct.pack(order + ("Q" if big else "H"), len(entries)))
    for tag, (typ, values) in entries:
        values = list(values)
        raw = _pack_values(typ, values, order)
        count = len(values)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\0")
        else:
            at = ifd_at + ifd_size + len(extra)
            extra += raw + (b"\0" if len(raw) % 2 else b"")
            field = struct.pack(order + ("Q" if big else "I"), at)
        body += struct.pack(order + "HH" + ("Q" if big else "I"), tag, typ, count) + field
    body += b"\0" * (8 if big else 4)
    out = bytes(data) + bytes(body) + bytes(extra)
    at = struct.pack(order + ("Q" if big else "I"), ifd_at)
    return out[:8] + at + out[16:] if big else out[:4] + at + out[8:]


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW as libtiff's encoder writes it (MSB-first, the width one
    code early), or the old style (LSB-first, on time) that LZW_COMPAT reads."""
    bits, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code: int) -> None:
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                bits.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                bits.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8

    def grow(free: int) -> None:
        nonlocal nbits
        if free > (1 << nbits) - (0 if compat else 1):
            nbits += 1

    table, free = {}, 258
    put(256)
    ent = data[0]
    for c in data[1:]:
        if (ent, c) in table:
            ent = table[(ent, c)]
            continue
        put(ent)
        table[(ent, c)] = free
        free += 1
        if free == 4094:
            put(256)
            table, free, nbits = {}, 258, 9
        else:
            grow(free)
        ent = c
    put(ent)
    grow(free + 1)
    put(257)
    if nacc:
        bits.append((acc << (8 - nacc)) & 0xFF if not compat else acc & 0xFF)
    return bytes(bits)


def pack_samples(rows: np.ndarray, bps: int, order: str) -> bytes:
    """(rows, samples a row) of ints as TIFF rows: bytes, big- or
    little-endian 16-bit words, or bits MSB first, each row padded to a
    byte."""
    if bps == 8:
        return rows.astype(np.uint8).tobytes()
    if bps == 16:
        return rows.astype(order + "u2").tobytes()
    if bps == 32:
        return rows.astype(order + "u4").tobytes()
    shifts = np.arange(bps - 1, -1, -1)
    return b"".join(np.packbits(((r[:, None].astype(np.int64) >> shifts) & 1).ravel()).tobytes() for r in rows)


def predict(rows: np.ndarray, stride: int, bps: int) -> np.ndarray:
    """Predictor 2: each sample less the one stride before it in its row."""
    d = rows.astype(np.int64).copy()
    d[:, stride:] -= rows[:, :-stride].astype(np.int64)
    return d % (1 << bps)


CODECS = {1: lambda b: b, 5: lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits,
          "lzw_compat": lambda b: lzw(b, compat=True), "deflate_stored": lambda b: zlib.compress(b, 0)}


def layout(px: np.ndarray, bps: int, *, planar: bool = False, tile=None, rps: int = 37, order: str = "<",
           compression=1, predictor: int = 1) -> tuple:
    """Strips or tiles of px (H, W, S) samples, compressed; returns
    (segments, layout tags). Tiles are padded with zeros to full size."""
    h, w, spp = px.shape
    segments = []
    encode = CODECS[compression]
    for b in blocks(px, tile=tile, rps=rps, planar=planar):
        rows = b.reshape(b.shape[0], -1)
        if predictor == 2:
            rows = predict(rows, b.shape[2], bps)
        segments.append(encode(pack_samples(rows, bps, order)))
    code = {"lzw_compat": 5, "deflate_stored": 8}.get(compression, compression)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [bps] * spp), 259: (3, [code]), 277: (3, [spp]),
            284: (3, [2 if planar else 1])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (3, [rps])
    return segments, tags


def ycbcr_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int, rps: int) -> list:
    """Raw YCbCr strips in TIFF's sampled layout: per block hs x vs luma,
    then one Cb and one Cr (the block's first), rows of blocks."""
    h, w = y.shape
    bh, bw = -(-h // vs), -(-w // hs)
    yp = np.zeros((bh * vs, bw * hs), np.uint8)
    yp[:h, :w] = y
    strips = []
    for s0 in range(0, bh * vs, rps):
        out = bytearray()
        for by in range(s0 // vs, min(bh, (s0 + rps) // vs)):
            for bx in range(bw):
                out += yp[by * vs:(by + 1) * vs, bx * hs:(bx + 1) * hs].tobytes()
                out += bytes([cb[min(by * vs, h - 1), min(bx * hs, w - 1)], cr[min(by * vs, h - 1), min(bx * hs, w - 1)]])
        strips.append(bytes(out))
    return strips


def _jpeg_split(data: bytes) -> tuple:
    """A JPEG's DQT and DHT segments as a tables-only stream, and the rest
    as an abbreviated stream."""
    tables, rest, i = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xDA:
            rest += data[i:]
            break
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        (tables if m in (0xDB, 0xC4) else rest).extend(data[i:i + 2 + n])
        i += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def jpeg_tiles(px: np.ndarray, tw: int, th: int, mode: str, tables: bool = True) -> tuple:
    """JPEG tiles of px (PIL's encoder, quality 90; 4:2:0 for YCbCr, 4:4:4
    RGB-coded for RGB, grey for L): (segments, JPEGTables or None)."""
    h, w = px.shape[:2]
    ny, nx = -(-h // th), -(-w // tw)
    padded = np.zeros((ny * th, nx * tw) + px.shape[2:], np.uint8)
    padded[:h, :w] = px
    kw = {"YCbCr": dict(subsampling=2), "RGB": dict(subsampling=0, keep_rgb=True), "L": {}}[mode]
    segs, table = [], None
    for ty in range(ny):
        for tx in range(nx):
            buf = io.BytesIO()
            Image.fromarray(padded[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]).save(buf, "JPEG", quality=90, **kw)
            data = buf.getvalue()
            if tables:
                t, data = _jpeg_split(data)
                assert table in (None, t)  # one set of tables for every tile
                table = t
            segs.append(data)
    return segs, table


def webp_pil(px: np.ndarray, **kw) -> bytes:
    """One WebP stream of px (H, W, 3 or 4) from PIL's encoder (``quality``,
    ``method``, ``lossless``, ...)."""
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP", **kw)
    return buf.getvalue()


# libwebp's advanced encoder API: the coding tools PIL does not expose.
WEBP_ENCODER = r"""
#include <string.h>
#include <webp/encode.h>
/* o: lossless quality method filter_type filter_strength sharpness partitions
   segments alpha_compression alpha_filtering alpha_quality exact */
int aq_webp_encode(const uint8_t* px, int w, int h, int ch, const int* o, uint8_t* out, int cap) {
  WebPConfig c;
  if (!WebPConfigInit(&c)) return -1;
  c.lossless = o[0]; c.quality = (float)o[1]; c.method = o[2];
  c.filter_type = o[3]; c.filter_strength = o[4]; c.filter_sharpness = o[5];
  c.partitions = o[6]; c.segments = o[7]; c.alpha_compression = o[8];
  c.alpha_filtering = o[9]; c.alpha_quality = o[10]; c.exact = o[11];
  c.autofilter = 0;
  if (!WebPValidateConfig(&c)) return -2;
  WebPPicture p;
  if (!WebPPictureInit(&p)) return -3;
  p.width = w; p.height = h; p.use_argb = 1;
  if (!(ch == 4 ? WebPPictureImportRGBA(&p, px, w * 4) : WebPPictureImportRGB(&p, px, w * 3))) return -4;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  p.writer = WebPMemoryWrite;
  p.custom_ptr = &wr;
  int ok = WebPEncode(&c, &p), n = (int)wr.size;
  WebPPictureFree(&p);
  if (!ok) n = -5;
  else if (n > cap) n = -6;
  else memcpy(out, wr.mem, wr.size);
  WebPMemoryWriterClear(&wr);
  return n;
}
"""

_WEBP_OPTIONS = ("lossless", "quality", "method", "filter_type", "filter_strength", "sharpness", "partitions",
                 "segments", "alpha_compression", "alpha_filtering", "alpha_quality", "exact")
_WEBP_DEFAULTS = dict(lossless=0, quality=75, method=4, filter_type=1, filter_strength=60, sharpness=0,
                      partitions=0, segments=4, alpha_compression=1, alpha_filtering=1, alpha_quality=100, exact=0)


def webp_encoder():
    """A function px (H, W, 3 or 4) uint8, **options -> WebP bytes through
    libwebp's WebPConfig (``_WEBP_OPTIONS``: filter type, strength and
    sharpness, token partitions as log2, segments, ALPH compression,
    filter and quality, ...), or None where no compiler or libwebp is
    here. The library is built once in the temp directory, under a lock."""
    tag = hashlib.sha1(WEBP_ENCODER.encode()).hexdigest()[:12]
    tmp = tempfile.gettempdir()
    so = os.path.join(tmp, f"aq_webp_encoder_{tag}.so")
    with open(os.path.join(tmp, "aq_webp_encoder.lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                src = os.path.join(tmp, f"aq_webp_encoder_{tag}.c")
                with open(src, "w") as f:
                    f.write(WEBP_ENCODER)
                built = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", so + ".tmp", src, "-lwebp"],
                                       capture_output=True)
                if built.returncode != 0:
                    return None
                os.replace(so + ".tmp", so)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    lib = ctypes.CDLL(so)
    lib.aq_webp_encode.restype = ctypes.c_int

    def encode(px: np.ndarray, **kw) -> bytes:
        px = np.ascontiguousarray(px, np.uint8)
        h, w, ch = px.shape
        opts = dict(_WEBP_DEFAULTS, **kw)
        o = (ctypes.c_int * len(_WEBP_OPTIONS))(*[int(opts[k]) for k in _WEBP_OPTIONS])
        out = np.zeros(w * h * ch * 2 + 65536, np.uint8)
        n = lib.aq_webp_encode(px.ctypes.data_as(ctypes.c_void_p), w, h, ch, o,
                               out.ctypes.data_as(ctypes.c_void_p), len(out))
        if n <= 0:
            raise RuntimeError(f"aq_webp_encode failed ({n})")
        return out[:n].tobytes()

    return encode


def webp_layout(px: np.ndarray, encode, *, tile=None, rps: int = 64) -> tuple:
    """WebP strips (the last one shorter) or tiles (full size, the edges
    padded with zeros) of px (H, W, 3 or 4), each encode(block) -> bytes;
    returns (segments, tags): 8-bit RGB, ExtraSamples 2 (unassociated
    alpha) on four samples."""
    h, w, spp = px.shape
    if tile:
        tw, th = tile
        ny, nx = -(-h // th), -(-w // tw)
        padded = np.zeros((ny * th, nx * tw, spp), np.uint8)
        padded[:h, :w] = px
        segments = [encode(padded[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw])
                    for ty in range(ny) for tx in range(nx)]
    else:
        segments = [encode(px[y:y + rps]) for y in range(0, h, rps)]
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8] * spp), 259: (3, [50001]), 262: (3, [2]), 277: (3, [spp]),
            284: (3, [1])}
    if spp == 4:
        tags[338] = (3, [2])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (3, [rps])
    return segments, tags


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) % 2 else b"")
                              for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _chunk(stream: bytes, tag: bytes) -> bytes:
    """The payload of a simple RIFF WebP's first chunk named tag."""
    at = 12
    while at + 8 <= len(stream):
        n = struct.unpack("<I", stream[at + 4:at + 8])[0]
        if stream[at:at + 4] == tag:
            return stream[at + 8:at + 8 + n]
        at += 8 + n + (n & 1)
    raise ValueError(f"no {tag!r} chunk")


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """ALPH's prediction (0 none, 1 horizontal, 2 vertical, 3 gradient) as
    libwebp's encoder applies it: the residuals libwebp's unfilters undo."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]  # the first row: horizontal from 0
        if method == 1:
            pred[1:, 0] = a[:-1, 0]
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:] = a[:-1]
        else:
            pred[1:, 0] = a[:-1, 0]
            grad = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
            pred[1:, 1:] = np.clip(grad, 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


def webp_with_alph(rgb: np.ndarray, alpha: np.ndarray, *, method: int = 0, filt: int = 0, pre: int = 0,
                   quality: int = 80) -> bytes:
    """A VP8X file: PIL's lossy VP8 stream of rgb and an ALPH chunk of
    alpha built here, raw (method 0) or VP8L-coded (1: PIL's lossless
    stream of the residuals as grey, without its 5-byte header), with the
    given prediction filter and pre-processing bits."""
    h, w = alpha.shape
    vp8 = _chunk(webp_pil(rgb, quality=quality), b"VP8 ")
    res = alpha_filter(alpha, filt)
    if method == 0:
        payload = res.tobytes()
    else:
        payload = _chunk(webp_pil(np.repeat(res[..., None], 3, -1), lossless=True), b"VP8L")[5:]
    alph = bytes([method | filt << 2 | pre << 4]) + payload
    vp8x = struct.pack("<I", 0x10) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    return _riff([(b"VP8X", vp8x), (b"ALPH", alph), (b"VP8 ", vp8)])


# ---------------------------------------------------------------- libtiff

# codec pseudo-tags (tiff.h)
TAG_PIXARLOGDATAFMT, TAG_PIXARLOGQUALITY, TAG_SGILOGDATAFMT, TAG_SGILOGENCODE = 65549, 65558, 65560, 65561
# LERC's and ZSTD's pseudo-tags (tif_lerc.c, tif_zstd.c): MaxZError is a double
TAG_ZSTD_LEVEL, TAG_LERC_VERSION, TAG_LERC_ADD_COMPRESSION, TAG_LERC_MAXZERROR = 65564, 65565, 65566, 65567
_UINT32_TAGS = {256, 257, 278, 322, 323}


def libtiff():
    """The system's libtiff through ctypes, or None where it does not load."""
    try:
        lib = ctypes.CDLL("libtiff.so.6")
    except OSError:
        return None
    vp = ctypes.c_void_p
    lib.TIFFOpen.restype, lib.TIFFOpen.argtypes = vp, [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile", "TIFFWriteRawStrip", "TIFFWriteRawTile"):
        f = getattr(lib, name)
        f.restype, f.argtypes = ctypes.c_ssize_t, [vp, ctypes.c_uint32, vp, ctypes.c_ssize_t]
    lib.TIFFClose.restype, lib.TIFFClose.argtypes = None, [vp]
    lib.TIFFSetErrorHandler.restype = vp
    lib.TIFFSetWarningHandler.restype = vp
    lib.TIFFSetErrorHandler(None)
    lib.TIFFSetWarningHandler(None)
    return lib


def libtiff_file(path, tags: dict, segments, *, raw: bool = False, tiled: bool = False, mode: str = "w") -> bool:
    """Write one image through libtiff: tags {tag: int, a float (passed as
    a double, as LERC's MaxZError wants), or a list for ExtraSamples} set
    with Compression first (so that its codec's pseudo-tags are known),
    then each segment's bytes through
    TIFFWriteEncodedStrip/Tile (the codec encodes them) or, raw, the raw
    writes. mode: TIFFOpen's ("w", "wb" big-endian, "w8" BigTIFF). False
    where libtiff refuses a tag or a write."""
    lib = libtiff()
    tif = lib.TIFFOpen(str(path).encode(), mode.encode())
    if not tif:
        return False
    ok = True
    for tag in sorted(tags, key=lambda t: (t != 259, t)):
        v = tags[tag]
        if isinstance(v, (list, tuple)):
            arr = (ctypes.c_uint16 * len(v))(*v)
            ok &= lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag), ctypes.c_int(len(v)), arr) == 1
        else:
            val = ctypes.c_double(v) if isinstance(v, float) else ctypes.c_uint32(v) if tag in _UINT32_TAGS \
                else ctypes.c_int(v)
            ok &= lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag), val) == 1
    write = {(False, False): lib.TIFFWriteEncodedStrip, (False, True): lib.TIFFWriteEncodedTile,
             (True, False): lib.TIFFWriteRawStrip, (True, True): lib.TIFFWriteRawTile}[raw, tiled]
    for i, seg in enumerate(segments):
        seg = bytes(seg)
        buf = ctypes.create_string_buffer(seg, len(seg))
        ok &= write(tif, i, buf, len(seg)) != -1
    lib.TIFFClose(tif)
    return bool(ok)


def lerc_blob(px: np.ndarray, version: int, *, max_z_error: float = 0.5, mask=None):
    """A Lerc2 blob of px (H, W, depth; uint8/int8/uint16/int16) at a codec
    version libtiff does not write (2-6), from the system's libLerc
    (lerc_encodeForVersion), mask (H, W: 1 valid) optional; None where
    libLerc is missing or refuses."""
    try:
        lerc = ctypes.CDLL("libLerc.so.4")
    except OSError:
        return None
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lerc.lerc_encodeForVersion.argtypes = [vp, i32, ctypes.c_uint, i32, i32, i32, i32, i32, vp, ctypes.c_double, vp,
                                           ctypes.c_uint, ctypes.POINTER(ctypes.c_uint)]
    px = np.ascontiguousarray(px if px.ndim == 3 else px[..., None])
    h, w, depth = px.shape
    dt = {np.dtype(np.int8): 0, np.dtype(np.uint8): 1, np.dtype(np.int16): 2, np.dtype(np.uint16): 3}[px.dtype]
    valid = None if mask is None else np.ascontiguousarray(mask, np.uint8)
    out = ctypes.create_string_buffer(px.nbytes * 2 + 4096)
    n = ctypes.c_uint()
    r = lerc.lerc_encodeForVersion(px.ctypes.data, version, dt, depth, w, h, 1, 0 if valid is None else 1,
                                   None if valid is None else valid.ctypes.data, max_z_error, out, len(out),
                                   ctypes.byref(n))
    return out.raw[:n.value] if r == 0 else None


def lerc_strips(px: np.ndarray, version: int, *, rps: int = 16, max_z_error: float = 0.5, alpha_mask: bool = False,
                edit=None, params=None, extra: dict = None) -> bytes:
    """A LERC TIFF (compression 34887, LercParameters params, by default
    [version, 0]) whose strips are lerc_blob's blobs laid raw, each after
    edit(list of blobs) where given (a wrapper, damage); alpha_mask: px's
    last sample (0 or 255) carried as the blob's mask, as tif_lerc.c stores
    unassociated alpha."""
    h, w, spp = px.shape
    segs = []
    for y in range(0, h, rps):
        block = px[y:y + rps]
        mask = None
        if alpha_mask:
            mask = block[..., -1] == 255
            block = block[..., :-1]
        segs.append(lerc_blob(block, version, max_z_error=max_z_error, mask=mask))
    bps = 8 * px.dtype.itemsize
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [bps] * spp), 259: (3, [34887]),
            262: (3, [2 if spp >= 3 else 1]), 277: (3, [spp]), 278: (3, [rps]), 50674: (4, params or [version, 0])}
    if px.dtype.kind == "i":
        tags[339] = (3, [2] * spp)
    if alpha_mask or spp in (2, 4):
        tags[338] = (3, [2])
    tags.update(extra or {})
    return tiff_bytes(edit(segs) if edit else segs, tags)


def blocks(px: np.ndarray, *, tile=None, rps: int = 16, planar: bool = False) -> list:
    """px (H, W, S) cut as libtiff lays out strips (the last one shorter) or
    tiles (the edges padded with zeros), each plane apart when planar."""
    h, w = px.shape[:2]
    planes = [px[..., p:p + 1] for p in range(px.shape[2])] if planar else [px]
    out = []
    for plane in planes:
        if tile:
            tw, th = tile
            ny, nx = -(-h // th), -(-w // tw)
            pad = np.zeros((ny * th, nx * tw) + plane.shape[2:], plane.dtype)
            pad[:h, :w] = plane
            out += [pad[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] for ty in range(ny) for tx in range(nx)]
        else:
            out += [plane[y:y + rps] for y in range(0, h, rps)]
    return out


# ---------------------------------------------------------------- NeXT, ThunderScan

def next_row(row: np.ndarray, mode: str) -> bytes:
    """One row of 2-bit pixels as a NeXT opcode: "literal" (0x00 and the
    packed row), "span" (0x40, the packed row's bytes that are not white,
    over white) or "runs" (<grey:2><count:6> bytes)."""
    packed = pack_samples(row[None], 2, "<")
    if mode == "literal":
        return b"\0" + packed
    if mode == "span":
        keep = [i for i, b in enumerate(packed) if b != 0xFF] or [0]
        a, b = keep[0], keep[-1] + 1
        return b"\x40" + struct.pack(">HH", a, b - a) + packed[a:b]
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 63:
            j += 1
        out.append(int(row[i]) << 6 | (j - i))  # counts of 1..63: never the opcodes 0x00 and 0x40
        i = j
    return bytes(out)


def thunder_row(row: np.ndarray) -> bytes:
    """One row of 4-bit pixels as ThunderScan codes: runs of the last pixel
    (never to the row's end: libtiff writes no pixel of a run that fills
    the row exactly), three 2-bit or two 3-bit deltas where they reach, raw
    pixels otherwise."""
    out, last, i, n = bytearray(), 0, 0, len(row)
    code2, code3 = {0: 0, 1: 1, -1: 3}, {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    while i < n:
        j = i
        while j < n - 1 and row[j] == last and j - i < 63:
            j += 1
        if j - i >= 2:
            out.append(j - i)
            i = j
            continue
        seq = [last] + [int(x) for x in row[i:i + 3]]
        steps = [seq[k + 1] - seq[k] for k in range(len(seq) - 1)]
        if len(steps) == 3 and all(d in code2 for d in steps):
            out.append(0x40 | code2[steps[0]] << 4 | code2[steps[1]] << 2 | code2[steps[2]])
            last, i = seq[3], i + 3
        elif len(steps) >= 2 and all(d in code3 for d in steps[:2]):
            out.append(0x80 | code3[steps[0]] << 3 | code3[steps[1]])
            last, i = seq[2], i + 2
        else:
            last = int(row[i])
            out.append(0xC0 | last)
            i += 1
    return bytes(out)


# ---------------------------------------------------------------- jbigkit

JBIG_ENCODER = r"""
#include <stdlib.h>
#include <string.h>
#include <jbig.h>
struct sink { unsigned char* out; long cap, n; };
static void put(unsigned char* start, size_t len, void* file) {
  struct sink* s = (struct sink*)file;
  if (s->n + (long)len <= s->cap) memcpy(s->out + s->n, start, len);
  s->n += (long)len;
}
/* bits: rows of ceil(w / 8) bytes, MSB first, 1 black; yd1: the height the
   BIH announces (a NEWLEN marker gives h); comment: a COMMENT segment;
   layers: differential resolution layers (D) */
long aq_jbig_encode(unsigned char* bits, unsigned long w, unsigned long h, int order, int options,
                    long l0, int mx, unsigned long yd1, unsigned char* comment, unsigned long comment_len,
                    int layers, unsigned char* out, long cap) {
  struct jbg_enc_state e;
  struct sink s = {out, cap, 0};
  unsigned char* planes[1] = {bits};
  jbg_enc_init(&e, w, h, 1, planes, put, &s);
  if (layers) jbg_enc_layers(&e, layers);
  jbg_enc_options(&e, order, options, l0, mx, 0);
  if (yd1) e.yd1 = yd1;
  if (comment_len) {
    e.comment = comment;
    e.comment_len = comment_len;
  }
  jbg_enc_out(&e);
  jbg_enc_free(&e);
  return s.n <= cap ? s.n : -1;
}
"""


def jbig_encoder():
    """A function bits (H, W) of 0/1, order, options, l0, mx, yd1, comment,
    layers -> a BIE through jbigkit's jbg_enc_options (one plane; yd1 a
    taller height announced in the BIH and a NEWLEN marker with the true
    one; a COMMENT segment; layers > 0 differential layers), or None where
    no compiler or libjbig is here. Built once in the temp
    directory, under a lock."""
    tag = hashlib.sha1(JBIG_ENCODER.encode()).hexdigest()[:12]
    tmp = tempfile.gettempdir()
    so = os.path.join(tmp, f"aq_jbig_encoder_{tag}.so")
    with open(os.path.join(tmp, "aq_jbig_encoder.lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                src = os.path.join(tmp, f"aq_jbig_encoder_{tag}.c")
                with open(src, "w") as f:
                    f.write(JBIG_ENCODER)
                built = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", so + ".tmp", src, "-ljbig"],
                                       capture_output=True)
                if built.returncode != 0:
                    return None
                os.replace(so + ".tmp", so)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    lib = ctypes.CDLL(so)
    lib.aq_jbig_encode.restype = ctypes.c_long
    lib.aq_jbig_encode.argtypes = [ctypes.c_void_p, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_long, ctypes.c_int, ctypes.c_ulong, ctypes.c_char_p, ctypes.c_ulong,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_long]

    def encode(bits: np.ndarray, order: int = 3, options: int = 0x1C, l0: int = 0, mx: int = 8, yd1: int = 0,
               comment: bytes = b"", layers: int = 0) -> bytes:
        h, w = bits.shape
        packed = np.ascontiguousarray(np.packbits(bits.astype(np.uint8), axis=1))
        out = np.zeros(packed.size * 4 + len(comment) + 65536, np.uint8)
        n = lib.aq_jbig_encode(packed.ctypes.data, w, h, order, options, l0, mx, yd1, comment, len(comment),
                               layers, out.ctypes.data, out.size)
        if n <= 0:
            raise RuntimeError("aq_jbig_encode failed")
        return out[:n].tobytes()

    return encode


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits in the other order (libtiff's JBIG strips at
    FillOrder 1)."""
    table = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
    return bytes(data).translate(table)


# ---------------------------------------------------------------- fixtures

def write_legacy_fixtures(d: str) -> dict:
    """One small file of each codec and mode a host without libtiff,
    libLerc and jbigkit cannot write, under d: name -> path.
    NeXT (mixed opcodes, min-is-white) and ThunderScan strips written
    here; PixarLog RGB at 8 bits and grey at 16 bits big-endian, LogL,
    LogLuv and LogLuv24 through libtiff's encoders; JBIG through libtiff's
    (its defaults: TPBON, three-line template) and through jbigkit's with
    the two-line template, AT moves on a periodic pattern, SDRST, a
    COMMENT and a NEWLEN; LERC (bare, Deflate and ZSTD; 8 and 16 bits; a
    mask), ZSTD, and associated alpha and CMYK in LZMA and JPEG, which stay
    on the PIL route. tests/data/torch_tiff/ holds them, with pixels.json."""
    h, w = 64, 96
    out = {}

    def path(name):
        out[name] = os.path.join(d, f"{name}.tif")
        return out[name]

    rng = np.random.default_rng(11)
    grey2 = np.minimum(image(12, h, w, 1)[..., 0] // 64, 3)
    grey2[:, 40:60] = 1
    rows = [next_row(grey2[r], ("literal", "span", "runs")[r % 3]) for r in range(h)]
    libtiff_file(path("next"), {256: w, 257: h, 258: 2, 259: 32766, 262: 0, 277: 1, 278: 16},
                 [b"".join(rows[y:y + 16]) for y in range(0, h, 16)], raw=True)
    grey4 = image(13, h, w, 1)[..., 0] // 16
    rows = [thunder_row(grey4[r]) for r in range(h)]
    libtiff_file(path("thunder"), {256: w, 257: h, 258: 4, 259: 32809, 262: 1, 277: 1, 278: 16},
                 [b"".join(rows[y:y + 16]) for y in range(0, h, 16)], raw=True)
    rgb = image(14, h, w, 3)
    libtiff_file(path("pixarlog_rgb8"), {256: w, 257: h, 259: 32909, 262: 2, 277: 3, 278: 16,
                                         TAG_PIXARLOGDATAFMT: 0},
                 [np.ascontiguousarray(b).tobytes() for b in blocks(rgb, rps=16)])
    g16 = image(15, h, w, 1).astype(np.uint16) * 257 + rng.integers(0, 257, (h, w, 1)).astype(np.uint16)
    libtiff_file(path("pixarlog_grey16_mm"), {256: w, 257: h, 259: 32909, 262: 1, 277: 1, 278: 24,
                                              TAG_PIXARLOGDATAFMT: 4},
                 [np.ascontiguousarray(b).tobytes() for b in blocks(g16, rps=24)], mode="wb")
    lum = (image(16, h, w, 1)[..., 0].astype(np.int16) * 24 + 11000).astype(np.int16)
    lum24 = (image(16, h, w, 1)[..., 0].astype(np.int16) * 6 + 4500).astype(np.int16)  # LogLuv24's 10-bit range
    u = (0.17 + image(17, h, w, 1)[..., 0] / 3000.0) * 32768
    v = (0.43 + image(18, h, w, 1)[..., 0] / 3000.0) * 32768
    luv = np.stack([lum, u.astype(np.int16), v.astype(np.int16)], -1)
    luv24 = np.stack([lum24, u.astype(np.int16), v.astype(np.int16)], -1)
    for name, comp, ph, px in (("sgilog_l16", 34676, 32844, lum[..., None]), ("sgilog_luv32", 34676, 32845, luv),
                               ("sgilog_luv24", 34677, 32845, luv24)):
        libtiff_file(path(name), {256: w, 257: h, 259: comp, 262: ph, 277: px.shape[2], 278: 16,
                                  TAG_SGILOGDATAFMT: 1, TAG_SGILOGENCODE: 0},
                     [np.ascontiguousarray(b).tobytes() for b in blocks(px, rps=16)])
    yy, xx = np.mgrid[0:h, 0:w]
    bits = ((grey2 >= 2) ^ ((xx // 5 + yy // 3) % 7 == 0)).astype(np.uint8)
    libtiff_file(path("jbig"), {256: w, 257: h, 258: 1, 259: 34661, 262: 0, 277: 1, 278: h},
                 [np.packbits(bits, axis=1).tobytes()])
    hj, wj = 128, 256  # AT moves need stripes of a few thousand pixels
    yy, xx = np.mgrid[0:hj, 0:wj]
    period = rng.integers(0, 2, (hj, 9)).astype(np.uint8)[yy, xx % 9]
    bie = jbig_encoder()(period, options=0x40 | 0x20 | 0x08 | 0x200, l0=32, mx=16, yd1=hj + 7,
                         comment=b"jbigkit 2.1")
    with open(path("jbig_lrltwo_at_sdrst"), "wb") as f:
        f.write(tiff_bytes([reverse_bits(bie)], {256: (3, [wj]), 257: (3, [hj]), 258: (3, [1]), 259: (3, [34661]),
                                                 262: (3, [0]), 277: (3, [1]), 278: (3, [hj])}))
    # LERC bare, in Deflate and in ZSTD, at 8 and 16 bits, with a mask (binary
    # unassociated alpha); ZSTD RGB; and the PIL route's associated alpha and
    # CMYK through LZMA and JPEG. The 8-bit LERC files are lossy: libLerc's
    # lossless 8-bit (Huffman) blobs end in four bytes it leaves unset, and
    # libtiff's buffer is not zeroed, so they differ from write to write.
    # The 16-bit ones: the first lossy, the second lossless.
    rgb16 = image(20, h, w, 3).astype(np.uint16) * 257 + 3
    rgba = image(21, h, w, 4)
    rgba[..., 3] = np.where(rgba[..., 3] > 128, 255, 0)
    grey16 = image(22, h, w, 1).astype(np.uint16) * 251
    for name, px, add, err, extra in (("lerc_rgb16_lossy", rgb16, 0, 64.0, {}),
                                      ("lerc_deflate_rgba8_mask", rgba, 1, 1.0, {338: [2]}),
                                      ("lerc_zstd_grey16", grey16, 2, 0.0, {}),
                                      ("lerc_zstd_rgb8", image(23, h, w, 3), 2, 1.0, {})):
        libtiff_file(path(name), {256: w, 257: h, 258: 8 * px.dtype.itemsize, 259: 34887, 262: 2 if px.shape[2] > 1 else 1,
                                  277: px.shape[2], 278: 16, TAG_LERC_ADD_COMPRESSION: add, TAG_LERC_MAXZERROR: err,
                                  **extra}, [np.ascontiguousarray(b).tobytes() for b in blocks(px, rps=16)])
    libtiff_file(path("zstd_rgb"), {256: w, 257: h, 258: 8, 259: 50000, 262: 2, 277: 3, 278: 16},
                 [np.ascontiguousarray(b).tobytes() for b in blocks(image(24, h, w, 3), rps=16)])
    premultiplied = image(25, h, w, 4)
    premultiplied[..., :3] = (premultiplied[..., :3].astype(np.uint32) * premultiplied[..., 3:] // 255).astype(np.uint8)
    cmyk = image(26, h, w, 4)
    for comp, label in ((34925, "lzma"), (7, "jpeg")):
        libtiff_file(path(f"{label}_rgba_associated"), {256: w, 257: h, 258: 8, 259: comp, 262: 2, 277: 4, 278: 16,
                                                        338: [1]},
                     [np.ascontiguousarray(b).tobytes() for b in blocks(premultiplied, rps=16)])
        libtiff_file(path(f"{label}_cmyk"), {256: w, 257: h, 258: 8, 259: comp, 262: 5, 277: 4, 278: 16},
                     [np.ascontiguousarray(b).tobytes() for b in blocks(cmyk, rps=16)])
    # one 128 px tile of each codec, which chip_smoke.py repeats into a
    # 1024 px file to time the host decode (LERC v4 lossless, as libLerc
    # writes it into a zeroed buffer)
    tile = image(27, 128, 128, 3) & 0xF0  # fewer noise bits: under the fixtures' 32 KiB
    tags = {256: (3, [128]), 257: (3, [128]), 258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]),
            322: (3, [128]), 323: (3, [128])}
    with open(path("rate_tile_lerc"), "wb") as f:
        f.write(tiff_bytes([lerc_blob(tile, 4)], {**tags, 259: (3, [34887]), 50674: (4, [4, 0])}, tiled=True))
    libtiff_file(path("rate_tile_zstd"), {256: 128, 257: 128, 258: 8, 259: 50000, 262: 2, 277: 3, 322: 128,
                                          323: 128}, [tile.tobytes()], tiled=True)
    return out
