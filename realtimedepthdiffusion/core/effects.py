"""Depth-based artistic effects (JAX).

Rebuild of GPUDepthEffect.cu:
- desaturation (src/GPUDepthEffect.cu:8-27): pointwise lerp toward gray
- haze (src/GPUDepthEffect.cu:74-93): dark-channel transmission model
- defocus/refocus (src/GPUDepthEffect.cu:29-72): depth-proportional box blur.
  The reference's kernel is a naive O(W*H*k^2) gather (its slowest kernel,
  SURVEY.md §3.4); here it is O(W*H) per window candidate via an exact
  integer summed-area table with fixed-offset box candidates, identical
  output up to f32 division rounding.

All three share one fused entry point (``apply_effect``) so solve+effect can
compile into a single program (the BASELINE.json north-star fusion).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DiffusionConfig

EFFECT_NONE = 0
EFFECT_DEFOCUS = 1  # key 'b' (refocus/blur), src/main.cpp:190-202
EFFECT_DESATURATION = 2  # key 'g', src/main.cpp:204-216
EFFECT_HAZE = 3  # key 'h', src/main.cpp:218-230


def desaturation(rgb: jnp.ndarray, gray: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """f = depth/255; out = f*gray + (1-f)*color (far pixels fade to gray)."""
    f = (depth.astype(jnp.float32) / 255.0)[..., None]
    out = f * gray.astype(jnp.float32)[..., None] + (1.0 - f) * rgb.astype(jnp.float32)
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


def haze(
    rgb: jnp.ndarray, depth: jnp.ndarray, cfg: DiffusionConfig = DiffusionConfig()
) -> jnp.ndarray:
    """t = exp(-haze_beta * depth/255); out = t*color + (1-t)*airlight
    (He et al. 2009 Eq. 1-2 with airlight 255)."""
    t = jnp.exp(-jnp.float32(cfg.haze_beta) * depth.astype(jnp.float32) / 255.0)[..., None]
    out = t * rgb.astype(jnp.float32) + (1.0 - t) * jnp.float32(cfg.haze_airlight)
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


_AUTO_WARNED: set = set()


def resolved_defocus_quality(cfg: DiffusionConfig, max_half: int) -> str:
    """'exact' or 'approx' after resolving the 'auto' quality (the shipped
    default): exact while max_half <= ``pallas_defocus_auto_max_half``
    (every <=1440p-class geometry), bounded-error approx above it (the 4K+
    aperture regime, where the candidate march is longest). The switch is
    LOUD: one warning per aperture regime per process, so no 4K user
    silently gets an unlabeled approximation. Every defocus caller (single
    image, batched, sharded) resolves through here."""
    q = cfg.pallas_defocus_quality
    if q != "auto":
        return q
    if max_half <= cfg.pallas_defocus_auto_max_half:
        return "exact"
    if max_half not in _AUTO_WARNED:
        _AUTO_WARNED.add(max_half)
        import logging

        logging.getLogger("realtimedepthdiffusion").warning(
            "defocus quality 'auto': aperture max_half %d exceeds the "
            "exact threshold (%d) — using bounded-error approx (stride %d; "
            "error ledger in PERF.md). Pass defocus quality 'exact' to "
            "force the exact blur.",
            max_half, cfg.pallas_defocus_auto_max_half,
            cfg.pallas_defocus_stride,
        )
    return "approx"


def defocus_candidates(max_half: int, cfg: DiffusionConfig) -> list:
    """The static window-half candidate set every defocus path iterates.

    'exact': every half-width 1..max_half — the reference semantics
    (src/GPUDepthEffect.cu:42-43 picks any integer window).
    'approx': every half up to ``pallas_defocus_exact_upto`` plus an
    arithmetic progression of ``pallas_defocus_stride`` above it (the 4K
    lever; candidate count 55 -> ~26 at stride 4).
    'auto' (default) resolves per aperture regime (resolved_defocus_quality).
    """
    if resolved_defocus_quality(cfg, max_half) != "approx":
        return list(range(1, max_half + 1))
    t = min(cfg.pallas_defocus_exact_upto, max_half)
    q = cfg.pallas_defocus_stride
    return list(range(1, t + 1)) + list(range(t + q, max_half + 1, q))


def snap_half_widths(
    half: jnp.ndarray, max_half: int, cfg: DiffusionConfig
) -> jnp.ndarray:
    """Snap per-pixel half-widths onto ``defocus_candidates`` (identity for
    'exact'): halves <= exact_upto pass through, larger ones round to the
    nearest stride step (ties upward), clamped to the largest candidate.

    The approx output is EXACTLY the defocus of the snapped field, so the
    approximation error is bounded by half a stride of window growth on
    already-large blur windows (relative area change <= stride/(2*half)).
    Idempotent, and applied identically by every defocus caller."""
    if resolved_defocus_quality(cfg, max_half) != "approx":
        return half
    t = min(cfg.pallas_defocus_exact_upto, max_half)
    q = cfg.pallas_defocus_stride
    hi = half.astype(jnp.int32)
    cmax = t + (max_half - t) // q * q
    snapped = jnp.clip(t + ((hi - t + q // 2) // q) * q, t, cmax)
    return jnp.where(hi <= t, hi, snapped).astype(half.dtype)


@functools.lru_cache(maxsize=None)
def aperture_thresholds(k: int) -> np.ndarray:
    """t[n] = the smallest float32 depth in [0, 255] whose window aperture
    int(k * d / 255) — f32 product then f32 quotient, as the reference
    computes it (src/GPUDepthEffect.cu:42-43) — is >= n, for n = 0..k, and
    t[k + 1] = inf. Computed once per k on the host with IEEE arithmetic,
    so the device needs only comparisons to reproduce the reference's
    knife edges exactly (a device quotient may differ in the last ulp)."""
    kk, c = np.float32(k), np.float32(255.0)

    def aperture(d):
        return int(kk * d / c)

    t = np.empty(k + 2, np.float32)
    t[0], t[k + 1] = 0.0, np.inf
    for n in range(1, k + 1):
        d = np.float32(255.0 * n / k)
        while aperture(d) < n:
            d = np.nextafter(d, np.float32(np.inf))
        while d > 0 and aperture(np.nextafter(d, np.float32(0.0))) >= n:
            d = np.nextafter(d, np.float32(0.0))
        t[n] = d
    return t


def defocus_half_widths(depth: jnp.ndarray, full_h: int, full_w: int,
                        cfg: DiffusionConfig = DiffusionConfig()) -> jnp.ndarray:
    """Per-pixel window half-width (int32) from depth: int(k * d/255) // 2,
    k = 0.025 * diagonal of the FULL (full_h, full_w) image, snapped by the
    defocus quality (identity for 'exact'). The device's estimate of the
    aperture is corrected by one step against ``aperture_thresholds``."""
    k = cfg.defocus_kernel_size(full_h, full_w)
    # Out-of-range depth (>255, possible on unclipped solver output) takes
    # the maximal window, exactly like d = 255.
    d = jnp.clip(depth.astype(jnp.float32), 0.0, 255.0)
    t = jnp.asarray(aperture_thresholds(k))
    ka = jnp.clip((jnp.float32(k) * d / 255.0).astype(jnp.int32), 0, k)
    ka = ka + (d >= t[ka + 1]).astype(jnp.int32) - (d < t[ka]).astype(jnp.int32)
    return snap_half_widths(ka // 2, k // 2, cfg)


def defocus(
    rgb: jnp.ndarray, depth: jnp.ndarray, cfg: DiffusionConfig = DiffusionConfig()
) -> jnp.ndarray:
    """Depth-proportional box blur via exact int32 summed-area table.

    Per-pixel window half-width = int(k * depth/255) // 2 with
    k = 0.025 * diagonal (src/GPUDepthEffect.cu:42-43); window
    [c-h, c+h-1] per axis clipped to the image; empty window passes the
    source pixel through (the count == 0 branch).

    Formulation: the box mean is computed for every *fixed* half-width
    value (four static SAT slices each) and the per-pixel result is a
    one-hot select over those candidates, with no per-pixel gather.
    k <= ~55 at 1080p, so there are at most ~28 half values. Internal work
    is channel-major (3, H, W).
    """
    h, w = depth.shape
    max_half = cfg.defocus_kernel_size(h, w) // 2
    half = defocus_half_widths(depth, h, w, cfg)

    chw = jnp.moveaxis(rgb, -1, 0).astype(jnp.int32)  # (3, h, w)
    sat = jnp.cumsum(jnp.cumsum(chw, axis=1), axis=2)
    sat = jnp.pad(sat, ((0, 0), (1, 0), (1, 0)))  # (3, h+1, w+1) exact int32
    # One edge-extended SAT: every candidate corner becomes a pure static
    # SLICE of this array (edge values implement the window clip since SAT
    # rows/cols saturate at the image border). The round-1 version edge-
    # padded the SAT 4x per candidate — ~100 materialized copies that XLA
    # couldn't fuse away; slices of one buffer fuse into the select chain.
    m = max_half
    sat_e = jnp.pad(sat, ((0, 0), (m, m), (m, m)), mode="edge")

    def corner(dy: int, dx: int) -> jnp.ndarray:
        """sat[:, clip(y+dy, 0, h), clip(x+dx, 0, w)] as a slice of sat_e."""
        return sat_e[:, m + dy : m + dy + h, m + dx : m + dx + w]

    out = jnp.moveaxis(rgb, -1, 0).astype(jnp.float32)  # half == 0 -> passthrough
    for hv in defocus_candidates(max_half, cfg):
        # Window rows [y-hv, y+hv-1] clipped: SAT corners at row indices
        # clip(y+hv, 0, h) and clip(y-hv, 0, h). The select takes the RAW box
        # sum; the clip count + division are hoisted below the loop (they
        # depend only on the pixel's own half — the one winning candidate —
        # and box sums < 2^24 are exact in f32, so the late divide is
        # bit-identical to a per-candidate divide).
        box = (
            corner(hv, hv) - corner(-hv, hv) - corner(hv, -hv) + corner(-hv, -hv)
        ).astype(jnp.float32)
        out = jnp.where((half == hv)[None], box, out)

    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    y0 = jnp.maximum(yy - half, 0)
    y1 = jnp.minimum(yy + half - 1, h - 1)
    x0 = jnp.maximum(xx - half, 0)
    x1 = jnp.minimum(xx + half - 1, w - 1)
    cnt = ((y1 - y0 + 1) * (x1 - x0 + 1)).astype(jnp.float32)
    out = jnp.where((half > 0)[None], out / cnt[None], out)
    return jnp.moveaxis(out.astype(jnp.uint8), 0, -1)


def apply_effect(
    effect: int,
    rgb: jnp.ndarray,
    gray: jnp.ndarray,
    depth: jnp.ndarray,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> jnp.ndarray:
    """Static dispatch over the sticky effect modes (src/main.cpp:190-230).

    ``effect`` is a Python int (modes are session state, not data), so each
    mode compiles to its own minimal program.
    """
    if effect == EFFECT_DEFOCUS:
        return defocus(rgb, depth, cfg)
    if effect == EFFECT_DESATURATION:
        return desaturation(rgb, gray, depth)
    if effect == EFFECT_HAZE:
        return haze(rgb, depth, cfg)
    return rgb
