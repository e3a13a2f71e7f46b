"""A TIFF writer byte by byte, for the cases PIL cannot write: tiles,
planar files, big-endian and BigTIFF files, Predictor 2 at 16 bits, bit
depths below 8, raw YCbCr in its sampled layout, JPEG tiles with their
tables in JPEGTables, old-style LZW, WebP strips and tiles (PIL's WebP
encoder, or libwebp's advanced API through a small C helper that g++
builds against the system's libwebp: ``webp_encoder``). Used by
tests/test_torch_tiff.py, tests/test_torch_tiff_webp.py and chip_smoke.py's
feed phase; imports neither JAX nor the port.
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


def _pack_values(typ: int, values, order: str) -> bytes:
    if typ == 5:
        return b"".join(struct.pack(order + "II", a, b) for a, b in values)
    return struct.pack(order + _FORMATS[typ] * len(values), *values)


def tiff_bytes(segments, tags: dict, *, big: bool = False, order: str = "<", tiled: bool = False) -> bytes:
    """A TIFF of one IFD: the segments' bytes (strips, or tiles when tiled)
    back to back after the header, then the IFD and the tag values that do
    not fit in their entries. tags: {tag: (type, values)}; the offsets and
    byte counts are added here."""
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
    entries = sorted(tags.items())
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
    planes = [px[..., p:p + 1] for p in range(spp)] if planar else [px]
    segments = []
    encode = CODECS[compression]
    for plane in planes:
        s = plane.shape[2]
        if tile:
            tw, th = tile
            ny, nx = -(-h // th), -(-w // tw)
            padded = np.zeros((ny * th, nx * tw, s), plane.dtype)
            padded[:h, :w] = plane
            blocks = [padded[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] for ty in range(ny) for tx in range(nx)]
        else:
            blocks = [plane[y:y + rps] for y in range(0, h, rps)]
        for b in blocks:
            rows = b.reshape(b.shape[0], -1)
            if predictor == 2:
                rows = predict(rows, s, bps)
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
