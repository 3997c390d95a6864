"""Color conversion ops (JAX).

JAX equivalent of the reference's use of cv::cvtColor(BGR2GRAY)
(src/main.cpp:111,138): OpenCV's exact fixed-point luma so the gray pyramid —
and therefore the edge weights — match the reference bit-for-bit.
"""

from __future__ import annotations

import jax.numpy as jnp


def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """RGB (H,W,3) uint8 -> gray (H,W) uint8.

    Fixed-point: (R*9798 + G*19235 + B*3735 + 16384) >> 15, identical to
    OpenCV's 8-bit BGR2GRAY path (channel order here is RGB; the reference
    loads BGR, so its channel-0 blue coefficient 3735 lands on our
    channel-2).
    """
    x = rgb.astype(jnp.int32)
    acc = x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384
    return (acc >> 15).astype(jnp.uint8)
