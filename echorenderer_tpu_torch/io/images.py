"""Image serialization (counterpart of echorenderer_tpu/io/images.py, in
numpy): PNG (pure python), PFM/NPY float formats, Radiance HDR, and the
reference's custom `.fpi` lossless float image format.

Rebuild of the reference InOut/Images layer (Serializer.cs dispatches on
extension; MagickSerializer handles png/jpeg/...; FpiSerializer.cs:14 is
the XOR-delta + varint float codec). We implement PNG natively (zlib) so
no external codec library is on the save path.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _to_srgb_u8(image: np.ndarray) -> np.ndarray:
    rgb = np.asarray(image, np.float32)
    l = np.clip(rgb, 0.0, 1.0)
    srgb = np.where(l <= 0.0031308, 12.92 * l, 1.055 * np.power(np.maximum(l, 1e-12), 1 / 2.4) - 0.055)
    return (np.clip(srgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path, image: np.ndarray, *, flip_y: bool = True, srgb: bool = True):
    """Save an (H, W, 3|4) linear float image as PNG. Row 0 of the array is
    the BOTTOM of the image (the renderer's y-up convention) unless flip_y
    is False."""
    Path(path).write_bytes(encode_png(image, flip_y=flip_y, srgb=srgb))


def encode_png(image: np.ndarray, *, flip_y: bool = True, srgb: bool = True) -> bytes:
    """PNG-encode an (H, W, 3|4) linear float image (see save_png)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] > 4:
        img = img[..., :3]
    if flip_y:
        img = img[::-1]
    data = _to_srgb_u8(img) if srgb else (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, c = data.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def load_png(path, *, srgb: bool = True) -> np.ndarray:
    """Minimal PNG loader (8-bit, color types 0/2/6, no interlace).
    Returns linear float32 (H, W, C) with row 0 at the bottom."""
    blob = Path(path).read_bytes()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        payload = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    assert bit_depth == 8, "only 8-bit PNG supported"
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        f = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if f == 0:
            rec = line
        elif f == 1:
            rec = line.copy()
            for i in range(channels, stride):
                rec[i] = (rec[i] + rec[i - channels]) & 0xFF
        elif f == 2:
            rec = (line + prev) & 0xFF
        elif f == 3:
            rec = line.copy()
            for i in range(stride):
                left = rec[i - channels] if i >= channels else 0
                rec[i] = (rec[i] + ((left + int(prev[i])) >> 1)) & 0xFF
        elif f == 4:
            rec = line.copy()
            for i in range(stride):
                a = rec[i - channels] if i >= channels else 0
                b = int(prev[i])
                cc = int(prev[i - channels]) if i >= channels else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                rec[i] = (rec[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
        out[y] = rec.astype(np.uint8)
        prev = out[y]
    img = out.reshape(h, w, channels).astype(np.float32) / 255.0
    if srgb:
        img = np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)
    return img[::-1].astype(np.float32)


# --- FPI: the reference's lossless float image format (FpiSerializer.cs) ---
# Layout: magic, version, width, height, channels, then per channel a
# XOR-delta stream of the float bits varint-encoded.

_FPI_MAGIC = b"FPI1"


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varints(data: bytes, count: int, pos: int):
    vals = np.zeros(count, np.uint32)
    for i in range(count):
        shift = 0
        v = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        vals[i] = v & 0xFFFFFFFF
    return vals, pos


def save_fpi(path, image: np.ndarray):
    img = np.ascontiguousarray(np.asarray(image, np.float32))
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    img = img.reshape(h, w, c)
    out = bytearray()
    out += _FPI_MAGIC
    out += struct.pack("<III", w, h, c)
    payload = bytearray()
    for ch in range(c):
        bits = img[..., ch].ravel().view(np.uint32)
        delta = np.concatenate([[bits[0]], bits[1:] ^ bits[:-1]])
        for v in delta:
            _write_varint(payload, int(v))
    out += zlib.compress(bytes(payload), 6)
    Path(path).write_bytes(bytes(out))


def load_fpi(path) -> np.ndarray:
    blob = Path(path).read_bytes()
    assert blob[:4] == _FPI_MAGIC, "not an fpi file"
    w, h, c = struct.unpack("<III", blob[4:16])
    payload = zlib.decompress(blob[16:])
    pos = 0
    channels = []
    for _ in range(c):
        delta, pos = _read_varints(payload, w * h, pos)
        acc = np.bitwise_xor.accumulate(delta.astype(np.uint32))  # XOR prefix scan
        channels.append(acc.view(np.float32).reshape(h, w))
    return np.stack(channels, axis=-1)


def save_hdr(path, image: np.ndarray, *, flip_y: bool = True):
    """Radiance RGBE `.hdr` writer (flat, no RLE). image: (H, W, >=3) linear."""
    rgb = np.asarray(image, np.float32)[..., :3]
    if flip_y:
        rgb = rgb[::-1]
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    exp = np.zeros(maxc.shape, np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.frexp(maxc[nz])[1]
    scale = np.where(nz, np.ldexp(256.0, -exp) , 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path, *, flip_y: bool = True) -> np.ndarray:
    """Radiance RGBE `.hdr` reader (flat + adaptive RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    nl = data.index(b"\n", pos)
    dims = data[pos:nl].decode().split()
    h, w = int(dims[1]), int(dims[3])
    payload = data[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (
            p + 4 <= len(payload)
            and payload[p] == 2 and payload[p + 1] == 2
            and (payload[p + 2] << 8 | payload[p + 3]) == w
        ):  # adaptive RLE scanline
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = payload[p]; p += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = payload[p]; p += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            payload, np.uint8, count, p
                        )
                        p += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(payload, np.uint8, w * 4, p).reshape(w, 4)
            rgbe[y] = row
            p += w * 4
    exp = rgbe[..., 3].astype(np.int32) - 136  # 128 bias + 8 mantissa bits
    # +0.5 centers the truncated mantissa bucket (standard RGBE decode)
    rgb = (rgbe[..., :3].astype(np.float32) + 0.5) * np.ldexp(1.0, exp)[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return rgb[::-1] if flip_y else rgb


def save_pfm(path, image: np.ndarray):
    """Portable FloatMap writer (color PF, little-endian)."""
    rgb = np.asarray(image, np.float32)[..., :3]
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(rgb.astype("<f4").tobytes())


def load_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        count = w * h * (3 if header == b"PF" else 1)
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4", count)
    shape = (h, w, 3) if header == b"PF" else (h, w)
    return data.reshape(shape).astype(np.float32)


_PIL_EXTS = {".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".webp", ".gif"}


def save(path, image: np.ndarray, **kw):
    """Extension-dispatch save (reference Serializer.Find, Serializer.cs:33).
    PNG/FPI/NPY/HDR/PFM are native; JPEG/TIFF/&c go through PIL (the host
    codec role ImageMagick plays for the reference, SURVEY.md §2b)."""
    ext = Path(path).suffix.lower()
    if ext == ".png":
        save_png(path, image, **kw)
    elif ext == ".fpi":
        save_fpi(path, image)
    elif ext == ".npy":
        np.save(path, np.asarray(image, np.float32))
    elif ext == ".hdr":
        save_hdr(path, image, **kw)
    elif ext == ".exr":
        from .exr import save_exr

        save_exr(path, image, **kw)
    elif ext == ".pfm":
        save_pfm(path, image)
    elif ext in _PIL_EXTS:
        from PIL import Image

        u8 = _to_srgb_u8(np.asarray(image)[::-1][..., :3] if kw.get("flip_y", True) else np.asarray(image)[..., :3])
        Image.fromarray(u8).save(path)
    else:
        raise ValueError(f"unsupported image extension {ext!r}")


def load(path) -> np.ndarray:
    ext = Path(path).suffix.lower()
    if ext == ".png":
        return load_png(path)
    if ext == ".fpi":
        return load_fpi(path)
    if ext == ".npy":
        return np.load(path)
    if ext == ".hdr":
        return load_hdr(path)
    if ext == ".exr":
        from .exr import load_exr

        return load_exr(path)
    if ext == ".pfm":
        return load_pfm(path)
    if ext in _PIL_EXTS:
        from PIL import Image

        arr = np.asarray(Image.open(path), np.float32) / 255.0
        return arr[::-1]
    raise ValueError(f"unsupported image extension {ext!r}")


load_image = load  # alias used by textures.ImportGrid
