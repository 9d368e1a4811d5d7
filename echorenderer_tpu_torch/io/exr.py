"""Minimal OpenEXR codec: 32-bit-float scanline images (counterpart of
echorenderer_tpu/io/exr.py, in numpy).

The reference saves/loads EXR through ImageMagick (InOut/Images/
MagickSerializer.cs); no EXR codec library ships in this environment, so
this implements the subset of the spec needed for HDR assets: single-part
scanline files, FLOAT or HALF channels, compression NONE (written) /
NONE + ZIPS + ZIP accepted (read) — ZIP being what real-world HDR
environment maps ship with. Channel names R, G, B (+ A).

Format reference: OpenEXR file layout (openexr.org documentation) —
magic 0x762f3101, version 2, attribute list, scanline offset table,
then per-scanline blocks of (y:int32, size:int32, data by channel).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MAGIC = 0x01312F76


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _channel_list(names, pixel_type: int) -> bytes:
    # pixel_type: 1 = HALF, 2 = FLOAT
    out = b""
    for n in sorted(names):  # EXR requires alphabetical channel order
        out += n.encode() + b"\x00" + struct.pack("<iBBBBi", pixel_type, 0, 0, 0, 0, 1)
        out += struct.pack("<i", 1)
    return out + b"\x00"


def _zip_encode(data: bytes) -> bytes:
    """Forward EXR ZIP transform: interleave halves, delta-predict, deflate
    (the exact inverse of _zip_decode; ImfZip.cpp compress)."""
    import zlib

    raw = np.frombuffer(data, np.uint8)
    half = (raw.size + 1) // 2
    inter = np.empty(raw.size, np.uint8)
    inter[:half] = raw[0::2]
    inter[half:] = raw[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16) + 128
    return zlib.compress((d % 256).astype(np.uint8).tobytes())


def save_exr(path, image: np.ndarray, *, flip_y: bool = True, compression: str = "none"):
    """Write an (H, W, 3|4) float image as a FLOAT EXR
    (compression: 'none' or 'zip')."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if flip_y:
        img = img[::-1]  # EXR scanlines go top-down; our row 0 is bottom
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    zip_mode = compression.lower() == "zip"
    lines_per_block = 16 if zip_mode else 1

    header = b""
    header += _attr("channels", "chlist", _channel_list(names, 2))
    header += _attr("compression", "compression", b"\x03" if zip_mode else b"\x00")
    header += _attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr("lineOrder", "lineOrder", b"\x00")  # increasing y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    preamble = struct.pack("<II", _MAGIC, 2)
    order = np.argsort(names)  # data stored in alphabetical channel order
    n_blocks = -(-h // lines_per_block)
    payloads = []
    for b in range(n_blocks):
        y = b * lines_per_block
        lines = min(lines_per_block, h - y)
        raw = bytearray()
        for line in range(lines):
            for ci in order:
                raw += img[y + line, :, ci].astype("<f4").tobytes()
        data = bytes(raw)
        if zip_mode:
            z = _zip_encode(data)
            data = z if len(z) < len(data) else data  # spec: keep raw if bigger
        payloads.append((y, data))

    offset0 = len(preamble) + len(header) + 8 * n_blocks
    offsets, blocks, off = [], bytearray(), offset0
    for y, data in payloads:
        offsets.append(off)
        blocks += struct.pack("<ii", y, len(data)) + data
        off += 8 + len(data)
    offset_table = struct.pack("<" + "Q" * n_blocks, *offsets)
    Path(path).write_bytes(preamble + header + offset_table + bytes(blocks))


def _read_attrs(blob: bytes, pos: int):
    attrs = {}
    while blob[pos] != 0:
        name_end = blob.index(b"\x00", pos)
        name = blob[pos:name_end].decode()
        pos = name_end + 1
        type_end = blob.index(b"\x00", pos)
        type_name = blob[pos:type_end].decode()
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        attrs[name] = (type_name, blob[pos : pos + size])
        pos += size
    return attrs, pos + 1


def _zip_decode(data: bytes) -> bytes:
    """EXR ZIP/ZIPS post-inflate decode (ImfZip.cpp): undo the delta
    predictor, then de-interleave the two halves into even/odd bytes."""
    import zlib

    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    # predictor d[i] = d[i-1] + d[i] - 128, vectorized as a cumulative sum
    raw = ((np.cumsum(raw.astype(np.int64) - 128)) + 128) % 256
    raw = raw.astype(np.uint8)
    out = np.empty(raw.size, np.uint8)
    half = (raw.size + 1) // 2
    out[0::2] = raw[:half]
    out[1::2] = raw[half:]
    return out.tobytes()


def load_exr(path, *, flip_y: bool = True) -> np.ndarray:
    """Read a scanline EXR (FLOAT or HALF channels; NONE/ZIPS/ZIP)."""
    blob = Path(path).read_bytes()
    magic, version = struct.unpack_from("<II", blob, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    attrs, pos = _read_attrs(blob, 8)

    compression = attrs["compression"][1][0]
    if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"unsupported EXR compression {compression} (NONE/ZIPS/ZIP only)")
    lines_per_block = {0: 1, 2: 1, 3: 16}[compression]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    # channels
    chl = attrs["channels"][1]
    channels = []
    cpos = 0
    while chl[cpos] != 0:
        nend = chl.index(b"\x00", cpos)
        cname = chl[cpos:nend].decode()
        ptype = struct.unpack_from("<i", chl, nend + 1)[0]
        channels.append((cname, ptype))
        cpos = nend + 1 + 16
    names = [c[0] for c in channels]
    row_bytes = sum(4 if pt == 2 else 2 for _, pt in channels) * w

    n_blocks = -(-h // lines_per_block)
    pos += 8 * n_blocks  # skip the offset table; blocks are sequential
    out = np.zeros((h, w, len(channels)), np.float32)
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", blob, pos)
        pos += 8
        payload = blob[pos : pos + size]
        pos += size
        lines = min(lines_per_block, y1 - y + 1)
        if compression and size < lines * row_bytes:
            payload = _zip_decode(payload)
        bpos = 0
        for line in range(lines):
            for cname, ptype in channels:  # per-line, alphabetical channels
                if ptype == 2:  # FLOAT
                    row = np.frombuffer(payload, "<f4", w, bpos)
                    bpos += 4 * w
                elif ptype == 1:  # HALF
                    row = np.frombuffer(payload, "<f2", w, bpos).astype(np.float32)
                    bpos += 2 * w
                else:
                    raise ValueError(f"unsupported pixel type {ptype}")
                out[y - y0 + line, :, names.index(cname)] = row

    # reorder alphabetical -> RGBA
    want = [n for n in ["R", "G", "B", "A"] if n in names]
    if want:
        out = out[..., [names.index(n) for n in want]]
    return out[::-1] if flip_y else out
