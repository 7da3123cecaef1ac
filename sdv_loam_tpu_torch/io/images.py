"""Image read/write/display helpers — the ImageRW / ImageDisplay equivalent.

Counterpart of `sdv_loam_tpu/io/images.py` (reference src/IOWrapper/OpenCV/
ImageRW_OpenCV.cpp + ImageDisplay_OpenCV.cpp). The port reads and writes
PNG files through a small codec of its own, built on `zlib` and numpy, so
the KITTI path needs neither OpenCV nor PIL and every machine decodes the
same bytes the same way. The codec covers non-interlaced PNGs of bit depth
8 or 16: grayscale, grayscale + alpha, RGB and RGBA, with all five row
filters. There is no GUI: `display` is a no-op.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each PNG colour type the codec reads and writes
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    """The Paeth predictor of each byte (PNG specification, section 9.4)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows, bpp):
    """Undo the row filters. rows: (h, 1 + rowbytes) uint8, each row led by
    its filter type; bpp: bytes per pixel. Returns (h, rowbytes) uint8.

    Rows of types None, Sub and Up reconstruct row by row. Average and Paeth
    depend on the reconstructed left neighbour and the row above, so those
    images reconstruct along anti-diagonals: pixel (r, x) is ready once
    (r, x - 1), (r - 1, x) and (r - 1, x - 1) are, which holds at step
    r + x for every pixel of the diagonal at once."""
    h = rows.shape[0]
    ftype = rows[:, 0].astype(np.int64)
    if ftype.size and ftype.max() > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    data = rows[:, 1:]
    if not ftype.any():
        return data.copy()
    w = data.shape[1] // bpp
    f = data.reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)   # zero row / column pad
    if ftype.max() <= 2:
        for r in range(h):
            if ftype[r] == 0:
                out[r + 1, 1:] = f[r]
            elif ftype[r] == 1:
                out[r + 1, 1:] = np.cumsum(f[r], axis=0) & 255
            else:
                out[r + 1, 1:] = (f[r] + out[r, 1:]) & 255
        return out[1:, 1:].reshape(h, w * bpp).astype(np.uint8)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        x = t - r
        a = out[r + 1, x]            # left
        b = out[r, x + 1]            # up
        c = out[r, x]                # up-left
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 255
    return out[1:, 1:].reshape(h, w * bpp).astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    """Decode PNG bytes. Returns (h, w) for grayscale, else (h, w, c) with
    the channels in the file's order (RGB, RGBA, gray + alpha); uint8 at
    bit depth 8, uint16 at 16."""
    if buf[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth "
                         f"{depth}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError("truncated PNG image data")
    data = _unfilter(raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        img = data.view(">u2").astype(np.uint16)
    else:
        img = data
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def encode_png(img: np.ndarray, filter_type: int = 1) -> bytes:
    """Encode (h, w) grayscale, (h, w, 2) gray + alpha, (h, w, 3) RGB or
    (h, w, 4) RGBA, uint8 or uint16, as a PNG whose rows all use
    `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, not {img.dtype}")
    if filter_type not in range(5):
        raise ValueError(f"bad PNG filter type {filter_type}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    data = np.ascontiguousarray(img.reshape(h, w, ch).astype(
        ">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(h, w, bpp)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)
    x[1:, 1:] = data
    a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[filter_type]
    filt = ((x[1:, 1:] - pred) & 255).astype(np.uint8).reshape(h, w * bpp)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), filt], 1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """A PNG file's samples as stored (OpenCV's IMREAD_UNCHANGED, but with
    colour channels in RGB order)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_gray(path: str) -> np.ndarray:
    """An image file as 8-bit grayscale (IMREAD_GRAYSCALE): 16-bit samples
    keep their high byte, colour images convert with the ITU-R BT.601
    weights, alpha is dropped."""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3:
        if img.shape[2] == 2:
            img = img[..., 0]
        else:
            rgb = img[..., :3].astype(np.int32)
            img = ((rgb[..., 0] * 4899 + rgb[..., 1] * 9617
                    + rgb[..., 2] * 1868 + (1 << 13)) >> 14).astype(np.uint8)
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """Write an image as an 8-bit PNG: (h, w) grayscale or (h, w, 3) RGB,
    values clipped to [0, 255] and truncated."""
    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def colorize_idepth(idepth: np.ndarray, valid=None) -> np.ndarray:
    """Jet-style colorization of an inverse-depth map ((H,W) -> (H,W,3) u8),
    the headless counterpart of CoarseTracker::debugPlotIDepthMap."""
    d = np.asarray(idepth, np.float32)
    if valid is None:
        valid = d > 0
    vals = d[valid]
    lo, hi = (np.percentile(vals, 5), np.percentile(vals, 95)) if vals.size \
        else (0.0, 1.0)
    t = np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    out = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    out[~valid] = 0
    return out


def display(name: str, img: np.ndarray, wait_ms: int = 1) -> None:
    """imshow's place: the port has no GUI, so this does nothing (the
    reference's dummy ImageDisplay when OpenCV is absent)."""
