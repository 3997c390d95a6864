"""Deterministic synthetic pair at the headline geometry (1080x1920).

The 12 dataset fingerprints top out at 853x1280, so the exact geometry the
headline benchmark ships — 5 pyramid levels and the max_half=27 defocus
aperture — needs its own end-to-end content. This pair provides it:
structured content
(smooth gradients + hard color edges + stripes, so edge weights span the
LUT range and box-mean differences survive averaging) with the dataset's
annotation contract (scribble blobs at depths {0,64,128,192,254} spread
across the frame). Pure host-side numpy, identical on every platform.

Consumed by tools/build_fingerprints.py (golden build, CPU backend),
chip_smoke.py and bench.py (the GPU runs, 1080p and a 2x2 4K upscale).
"""

from __future__ import annotations

import numpy as np

SHAPE = (1080, 1920)


def synthetic_1080p():
    """Return (rgb u8 HxWx3, mask bool HxW, value u8 HxW) at 1080x1920."""
    h, w = SHAPE
    yy = np.arange(h, dtype=np.int32)[:, None]
    xx = np.arange(w, dtype=np.int32)[None, :]
    rgb = np.zeros((h, w, 3), np.uint8)
    # Smooth orthogonal gradients: weights vary continuously.
    rgb[..., 0] = (xx * 255 // (w - 1)).astype(np.uint8)
    rgb[..., 1] = ((h - 1 - yy) * 255 // (h - 1)).astype(np.uint8)
    # Hard horizontal bands + thin vertical stripes: strong edges that the
    # threshold-4 weight rule (C10) actually gates, and content whose box
    # means differ between adjacent defocus window sizes.
    band = ((yy // 135) % 2 == 1)
    rgb[..., 2] = np.where(band, 255, 0).astype(np.uint8)
    stripe = (xx % 96) < 10
    rgb[np.broadcast_to(stripe, (h, w))] = 255
    # A solid block breaking both gradients (isolated region for diffusion).
    rgb[400:700, 800:1200] = (255, 0, 0)

    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 64, 128, 192, 254)):
        cy = (i + 1) * h // 6
        cx = (i + 1) * w // 6
        mask[cy - 10 : cy + 10, cx - 14 : cx + 14] = True
        value[cy - 10 : cy + 10, cx - 14 : cx + 14] = d
    # One near scribble inside the solid block so the defocus map reaches
    # its maximum half-width (27 at this diagonal) over textured content.
    mask[520:560, 960:1040] = True
    value[520:560, 960:1040] = 254
    return rgb, mask, value
