"""Annotation (scribble) ops in JAX.

The reference carries scribbles as a pair of images — an 8UC3 "edited" image
whose channel 0 holds the depth value and an 8UC1 mask (255 = scribbled)
(src/main.cpp:24-27). Since a scribbled pixel always has all three channels
equal to the scribble value (paintImage, src/GPUImageProcessing.cu:65-68, and
the annotation loader, src/main.cpp:162-168), this framework represents an
annotation as the pair (mask: bool HxW, value: uint8 HxW) — strictly
equivalent and vector-friendly (no interleaved channels).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def annotation_pyr_down(
    mask: jnp.ndarray, value: jnp.ndarray, out_shape: Tuple[int, int]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Downsample an annotation one pyramid level.

    Semantics of the pyrDown kernel (src/GPUImageProcessing.cu:23-49): coarse
    (y,x) scans fine {2y-1,2y}x{2x-1,2x} in row-major order; any masked fine
    pixel masks the coarse pixel, and the LAST masked fine pixel in scan
    order supplies the value.

    Formulation: the 2x2 priority select becomes a single int32
    ``reduce_window`` max over packed keys instead of strided uint8/bool
    slicing.

    Key packing: masked pixels carry ((rank+1) << 8) | value where rank is
    the pixel's position priority inside its window — even row/col = written
    later in the reference's scan = higher rank; unmasked pixels carry 0.
    Ranks are unique within a window, so the max picks exactly the
    last-writer-wins pixel.
    """
    oh, ow = out_shape
    h, w = mask.shape
    # rank = 2*(row is even) + (col is even): fine pixel (2y,2x) has rank 3,
    # (2y,2x-1) -> 2, (2y-1,2x) -> 1, (2y-1,2x-1) -> 0.
    ry = 1 - (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) & 1)
    rx = 1 - (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) & 1)
    rank = 2 * ry + rx
    packed = jnp.where(
        mask, ((rank + 1) << 8) | value.astype(jnp.int32), 0
    )
    # Window {2y-1, 2y} x {2x-1, 2x}: pad one row/col on top/left, then a
    # (2,2)-stride-(2,2) max. Bottom/right padding covers odd sizes.
    win = jax.lax.reduce_window(
        packed,
        jnp.int32(0),
        jax.lax.max,
        window_dimensions=(2, 2),
        window_strides=(2, 2),
        padding=((1, 2 * oh - h + 1), (1, 2 * ow - w + 1)),
    )[:oh, :ow]
    return win != 0, (win & 255).astype(jnp.uint8)


def seed_depth(depth: jnp.ndarray, mask: jnp.ndarray, value: jnp.ndarray) -> jnp.ndarray:
    """Dirichlet seeding (convert kernel, src/GPUImageProcessing.cu:8-21):
    where masked, depth := scribble value; elsewhere keep the incoming depth
    (initial 255 or the pyrUp'd coarse solution)."""
    return jnp.where(mask, value.astype(jnp.float32), depth.astype(jnp.float32))


def paint(
    mask: jnp.ndarray,
    value: jnp.ndarray,
    x: jnp.ndarray | int,
    y: jnp.ndarray | int,
    color: jnp.ndarray | int,
    radius: jnp.ndarray | int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Square-brush paint (paintImage kernel, src/GPUImageProcessing.cu:51-70).

    Jit-safe: brush position/color/radius may be traced scalars, so one
    compiled program serves every stroke of an interactive session. Paints
    pixels with |px-x| <= radius//2 and |py-y| <= radius//2.
    """
    h, w = mask.shape
    half = jnp.maximum(jnp.asarray(radius, jnp.int32), 0) // 2
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    hit = (jnp.abs(xx - jnp.asarray(x, jnp.int32)) <= half) & (
        jnp.abs(yy - jnp.asarray(y, jnp.int32)) <= half
    )
    return mask | hit, jnp.where(hit, jnp.asarray(color, jnp.uint8), value)
