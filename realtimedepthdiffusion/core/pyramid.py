"""Image-pyramid ops (JAX), floor-size convention.

The reference mixes two pyramid conventions — floor sizes for its own buffers
(src/main.cpp:103, src/GPUSolver.cu:42-43) and OpenCV's ceil sizes for
pyrDown/pyrUp, papered over with host round-trips (SURVEY.md quirk #7 / bug
#1: the GPU pyrDown guard is dead code and the CPU fallback always runs).
This framework owns ONE convention: every level l has size (H>>l, W>>l), and
pyrDown/pyrUp are implemented natively in XLA with reflect-101 borders and
the classic 5-tap Gaussian [1,4,6,4,1]/16 — no host transfers, fully
jit-compatible, static shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_KI = (1, 4, 6, 4, 1)


def _reflect_pad2(a: jnp.ndarray) -> jnp.ndarray:
    """Reflect-101 pad of 2 on both leading axes (matches np.pad 'reflect')."""
    pad = [(2, 2), (2, 2)] + [(0, 0)] * (a.ndim - 2)
    return jnp.pad(a, pad, mode="reflect")


def _pyr_down_gray_to(gray: jnp.ndarray, oh: int, ow: int) -> jnp.ndarray:
    p = _reflect_pad2(gray).astype(jnp.int32)
    # Out-of-range slice ends clamp (Python semantics), which for the ceil
    # size on an odd axis still yields exactly oh/ow samples — the last tap
    # lands on the reflect-101 pad.
    acc = sum(_KI[t] * p[:, t : t + 2 * ow : 2] for t in range(5))
    out = sum(_KI[t] * acc[t : t + 2 * oh : 2, :] for t in range(5))
    return ((out + 128) >> 8).astype(jnp.uint8)


def pyr_down_gray(gray: jnp.ndarray) -> jnp.ndarray:
    """uint8 Gaussian pyrDown to (H//2, W//2).

    Integer kernel (sum 256) with round-half-up — the same fixed-point
    arithmetic as OpenCV's 8U path, so the gray pyramid matches the
    reference's cv::pyrDown chain wherever sizes agree.
    """
    h, w = gray.shape
    return _pyr_down_gray_to(gray, h // 2, w // 2)


def pyr_down_gray_ceil(gray: jnp.ndarray) -> jnp.ndarray:
    """uint8 Gaussian pyrDown to OpenCV's native ((H+1)//2, (W+1)//2) —
    bit-exact with cv::pyrDown (verified in tests/test_faithful.py). Used by
    the reference-faithful gray chain (config gray_pyramid="opencv"): the
    binary's CPU pyrDown fallback (src/main.cpp:241-247, always taken — bug
    #1) builds ceil-size levels that the solver consumes cropped to its
    floor-size rows/cols."""
    h, w = gray.shape
    return _pyr_down_gray_to(gray, (h + 1) // 2, (w + 1) // 2)


def pyr_up(src: jnp.ndarray, out_shape: Tuple[int, int]) -> jnp.ndarray:
    """float32 Gaussian pyrUp (zero-insert + 5-tap kernel x4) to an explicit
    target size, which under the floor convention is (2h) or (2h+1) per axis.

    JAX equivalent of cv::cuda::pyrUp on the depth map between
    multigrid levels (src/main.cpp:272-279), without the reference's
    odd-size host fallback. Border semantics match cv::pyrUp (verified
    against cv2 in tests/test_faithful.py): reflect-101 on the
    *zero-inserted* grid, with OpenCV's axis-asymmetric odd-size extension —
    odd height copies the previous even output row (out[2h] = out[2h-2]),
    odd width takes the last source column at full kernel weight
    (out[:, 2w] = vertically-filtered src[:, w-1]).
    """
    oh, ow = out_shape
    x = src.astype(jnp.float32)

    def axis_up(a: jnp.ndarray, n_out: int, odd_copy_out: bool) -> jnp.ndarray:
        h = a.shape[0]
        # Zero-insert: z[2i] = a[i], z[2i+1] = 0 (stack + reshape, no gather).
        z = jnp.stack([a, jnp.zeros_like(a)], axis=1).reshape((2 * h,) + a.shape[1:])
        zp = jnp.pad(z, [(2, 2)] + [(0, 0)] * (a.ndim - 1), mode="reflect")
        out = (
            zp[0 : 2 * h]
            + 4.0 * zp[1 : 2 * h + 1]
            + 6.0 * zp[2 : 2 * h + 2]
            + 4.0 * zp[3 : 2 * h + 3]
            + zp[4 : 2 * h + 4]
        ) * jnp.float32(0.125)
        if n_out == 2 * h + 1:
            extra = out[2 * h - 2 : 2 * h - 1] if odd_copy_out else a[h - 1 : h]
            out = jnp.concatenate([out, extra.astype(jnp.float32)], axis=0)
        return out[:n_out]

    t = axis_up(x, oh, odd_copy_out=True)
    t = jnp.swapaxes(axis_up(jnp.swapaxes(t, 0, 1), ow, odd_copy_out=False), 0, 1)
    return t.astype(jnp.float32)
