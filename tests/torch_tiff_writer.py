"""A TIFF writer byte by byte, for the cases PIL cannot write: tiles,
planar files, big-endian and BigTIFF files, Predictor 2 at 16 bits, bit
depths below 8, raw YCbCr in its sampled layout, JPEG tiles with their
tables in JPEGTables, old-style LZW. Used by tests/test_torch_tiff.py and
chip_smoke.py's feed phase; imports neither JAX nor the port.
"""

from __future__ import annotations

import io
import struct
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
          "lzw_compat": lambda b: lzw(b, compat=True)}


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
    code = 5 if compression == "lzw_compat" else compression
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
