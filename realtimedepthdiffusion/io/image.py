"""Image + annotation I/O boundary.

Per BASELINE.json, external imaging libraries are confined to this module:
everything inside the framework operates on numpy/JAX arrays. PNG is read
and written by a numpy + zlib codec here (8-bit gray, 8-bit RGB and 16-bit
gray out; every non-interlaced PNG in), so the annotation contract, the
depth exports and the effect PNGs need nothing beyond numpy. Pillow is
optional, for other formats (JPEG inputs) only.

Annotation checkpoint format — exactly the reference contract
(src/main.cpp:160-170 load, :297-318 save):
- grayscale PNG, one byte per pixel
- value 32  = unannotated sentinel
- any other value = scribbled depth (the dataset uses {0,64,128,192,254})
The annotation PNG round-trips a session: it is the checkpoint/resume format
(SURVEY.md §5).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from ..config import DiffusionConfig

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pil():
    try:
        from PIL import Image  # local import: I/O boundary only
    except ImportError:
        raise ImportError(
            "reading or writing non-PNG images needs the 'Pillow' package "
            "(pip install pillow); PNG needs nothing beyond numpy"
        ) from None
    return Image


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _PNG_MAGIC


def _png_chunks(data: bytes):
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        yield kind, data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _png_header(path: str) -> Tuple[int, int, int, int, int]:
    """(height, width, bit depth, color type, interlace) from IHDR."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _PNG_MAGIC or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", head[16:29])
    return h, w, depth, ctype, interlace


def _unfilter(ft: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) of ``data`` (rows x bytes, uint8). Rows of types 0-2 decode
    row by row; Average and Paeth depend on the left AND upper neighbour,
    so an image holding them decodes along anti-diagonals of pixels."""
    h, nbytes = data.shape
    if np.all(ft <= 2):
        out = np.empty_like(data)
        prev = np.zeros(nbytes, np.uint8)
        for r in range(h):
            x = data[r]
            if ft[r] == 1:
                x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif ft[r] == 2:
                x = x + prev
            out[r] = x
            prev = out[r]
        return out
    npx = nbytes // bpp
    raw = data.reshape(h, npx, bpp).astype(np.int32)
    # out[r + 1, p + 1] holds pixel (r, p); row 0 and column 0 stay zero.
    out = np.zeros((h + 1, npx + 1, bpp), np.int32)
    for d in range(h + npx - 1):
        r = np.arange(max(0, d - npx + 1), min(h - 1, d) + 1)
        p = d - r
        a = out[r + 1, p]
        b = out[r, p + 1]
        c = out[r, p]
        f = ft[r][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0
        )
        out[r + 1, p + 1] = (raw[r, p] + pred) & 255
    return out[1:, 1:].reshape(h, nbytes).astype(np.uint8)


def png_read(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG: (H, W) or (H, W, C) samples, uint8 or
    (16-bit files) uint16, palette images expanded to RGB(A)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    idat, plte, trns = [], None, None
    for kind, body in _png_chunks(blob):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    nbytes = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (nbytes + 1)].reshape(h, nbytes + 1)
    rows = _unfilter(raw[:, 0], raw[:, 1:], max(bits // 8, 1))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:  # 1/2/4-bit gray or palette indices
        img = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        img = (img * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        img = img[..., None]
    if ctype == 3:
        idx = img[..., 0]
        img = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[: len(trns)] = trns
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
    return img[..., 0] if img.shape[-1] == 1 else img


def png_write(path: str, arr: np.ndarray, level: int = 6) -> None:
    """Encode uint8 (H, W) gray / (H, W, 3) RGB or uint16 (H, W) gray as a
    PNG (every row Up-filtered, zlib ``level``)."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    if arr.dtype == np.uint16 and arr.ndim == 2:
        depth, ctype, rows = 16, 0, arr.astype(">u2").view(np.uint8)
    elif arr.dtype == np.uint8 and arr.ndim == 2:
        depth, ctype, rows = 8, 0, arr
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        depth, ctype, rows = 8, 2, arr
    else:
        raise ValueError(
            f"png_write takes uint8 (H,W)/(H,W,3) or uint16 (H,W), got "
            f"{arr.dtype} {arr.shape}"
        )
    rows = rows.reshape(h, -1)
    up = rows - np.concatenate([np.zeros_like(rows[:1]), rows[:-1]])  # wraps
    filtered = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
                + chunk(b"IEND", b""))


def imread_rgb(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB (alpha dropped; 16-bit samples
    keep their high byte)."""
    if not _is_png(path):
        return np.asarray(_pil().open(path).convert("RGB"), dtype=np.uint8)
    img = png_read(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def image_size(path: str) -> Tuple[int, int]:
    """(H, W) of an image from its header alone — no pixel decode. Matches
    ``imread_rgb``'s output shape (no EXIF transpose is applied on either
    path). Lets batch serving shape-bucket thousands of pairs without
    holding their decoded pixels in host RAM."""
    if _is_png(path):
        return _png_header(path)[:2]
    with _pil().open(path) as img:
        w, h = img.size
    return h, w


def imread_gray(path: str) -> np.ndarray:
    """Load an image as (H, W) uint8 grayscale, with Pillow's 'L'
    conversion: ITU-R 601-2 luma (R*19595 + G*38470 + B*7471 + 2^15) >> 16
    for color, alpha dropped, 16-bit gray clipped to 255."""
    if not _is_png(path):
        return np.asarray(_pil().open(path).convert("L"), dtype=np.uint8)
    img = png_read(path)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        rgb = img[..., :3].astype(np.uint32)
        if img.dtype == np.uint16:
            rgb = rgb >> 8
        luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
        return ((luma + 0x8000) >> 16).astype(np.uint8)
    if img.ndim == 3:  # gray + alpha
        img = img[..., 0]
    if img.dtype == np.uint16:
        return np.minimum(img, 255).astype(np.uint8)
    return img


def imwrite(path: str, arr: np.ndarray, png_level: int | None = None) -> None:
    """Write uint8 (H,W) gray / (H,W,3) RGB, or uint16 (H,W) gray (16-bit
    PNG — the ``depth_to_u16`` export path). PNG (by extension) goes
    through the numpy codec; other formats need Pillow.

    ``png_level`` (0-9, PNG outputs only) sets the zlib effort: default 6;
    level 1 encodes several times faster at a modest size cost — the
    serving-throughput knob, since PNG encode is host work on every pair."""
    arr = np.asarray(arr)
    if not (arr.dtype == np.uint16 and arr.ndim == 2):
        arr = arr.astype(np.uint8)
    if path.lower().endswith(".png"):
        png_write(path, arr, 6 if png_level is None else int(png_level))
        return
    _pil().fromarray(arr).save(path)


def load_annotation(
    path: str, cfg: DiffusionConfig = DiffusionConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an annotation PNG into (mask bool, value uint8).

    Reference semantics (src/main.cpp:160-168): every pixel != sentinel(32)
    is annotated; its gray value is the scribbled depth.
    """
    ann = imread_gray(path)
    mask = ann != np.uint8(cfg.annotation_sentinel)
    value = np.where(mask, ann, np.uint8(0)).astype(np.uint8)
    return mask, value


def save_annotation(
    path: str,
    mask: np.ndarray,
    value: np.ndarray,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> None:
    """Encode (mask, value) back to the annotation PNG contract: scribbled
    pixels keep their value, everything else becomes the sentinel. Inverse of
    ``load_annotation`` (the checkpoint round-trip)."""
    ann = np.where(mask, value, np.uint8(cfg.annotation_sentinel)).astype(np.uint8)
    imwrite(path, ann)


def depth_to_u8(depth: np.ndarray) -> np.ndarray:
    """float32 depth -> uint8 with saturation + round-half-to-even, matching
    GpuMat::convertTo(CV_8UC1) (src/main.cpp:290)."""
    return np.clip(np.rint(depth), 0, 255).astype(np.uint8)


def depth_to_u16(depth: np.ndarray) -> np.ndarray:
    """float32 depth -> uint16 at full solver precision (u16 = depth * 257,
    the standard 8-to-16-bit replication scale: 255 maps exactly to 65535
    and u16 // 257 recovers depth_to_u8 up to rounding). The solve converges
    well below one 8-bit gray level (post-solve RMS residual ~0.2, PERF.md),
    so the 16-bit export preserves real signal the u8 display path
    quantizes away — the reference has no such export (it saves the 8-bit
    display map, src/main.cpp:303-310). The multiply runs in float32 so this
    host form and DepthPipeline.depth_u16's on-device form are the same
    IEEE operation (a float64 product can round a knife-edge value to the
    other side of .5)."""
    scaled = depth.astype(np.float32) * np.float32(257.0)
    return np.clip(np.rint(scaled), 0, 65535).astype(np.uint16)
