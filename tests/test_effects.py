"""Depth effects: JAX vs oracle, SAT defocus vs the naive O(k^2) oracle."""

import numpy as np
import jax.numpy as jnp

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import effects
from realtimedepthdiffusion.oracle import numpy_ref as oracle

CFG = DiffusionConfig()


def _case(rng, h=60, w=80):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gray = oracle.rgb_to_gray(rgb)
    depth = (rng.random((h, w), dtype=np.float32) * 255).astype(np.float32)
    return rgb, gray, depth


def test_desaturation(rng):
    rgb, gray, depth = _case(rng)
    got = np.asarray(effects.desaturation(jnp.asarray(rgb), jnp.asarray(gray), jnp.asarray(depth)))
    want = oracle.desaturation(rgb, gray, depth)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # near (depth 0) keeps color; far (255) is gray
    d0 = np.zeros_like(depth)
    out0 = np.asarray(effects.desaturation(jnp.asarray(rgb), jnp.asarray(gray), jnp.asarray(d0)))
    assert np.array_equal(out0, rgb)
    d255 = np.full_like(depth, 255.0)
    out255 = np.asarray(effects.desaturation(jnp.asarray(rgb), jnp.asarray(gray), jnp.asarray(d255)))
    assert np.abs(out255.astype(int) - gray[..., None].astype(int)).max() <= 1


def test_haze(rng):
    rgb, gray, depth = _case(rng)
    got = np.asarray(effects.haze(jnp.asarray(rgb), jnp.asarray(depth), CFG))
    want = oracle.haze(rgb, depth, CFG)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # depth 0 -> t=1 -> unchanged; far -> toward airlight 255
    out0 = np.asarray(effects.haze(jnp.asarray(rgb), jnp.asarray(np.zeros_like(depth)), CFG))
    assert np.array_equal(out0, rgb)
    outfar = np.asarray(effects.haze(jnp.asarray(rgb), jnp.asarray(np.full_like(depth, 255.0)), CFG))
    assert outfar.min() >= 220  # t=exp(-2)~0.135 pulls everything near white


def test_defocus_sat_vs_naive(rng):
    rgb, gray, depth = _case(rng, 48, 64)
    want = oracle.defocus_naive(rgb, depth, CFG)
    sat = oracle.defocus(rgb, depth, CFG)
    got = np.asarray(effects.defocus(jnp.asarray(rgb), jnp.asarray(depth), CFG))
    # SAT is exact integer math; only f32-division rounding can differ: <=1
    assert np.abs(sat.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_defocus_near_pixels_sharp(rng):
    """depth 0 -> empty window -> passthrough (count==0 branch,
    src/GPUDepthEffect.cu:62-65)."""
    rgb, gray, _ = _case(rng, 160, 208)  # k = int(0.025*diag) = 6
    depth = np.zeros((160, 208), np.float32)
    got = np.asarray(effects.defocus(jnp.asarray(rgb), jnp.asarray(depth), CFG))
    assert np.array_equal(got, rgb)
    # graded depth: far pixels differ from the source (blurred), near don't
    depth[:, 104:] = 255.0
    got2 = np.asarray(effects.defocus(jnp.asarray(rgb), jnp.asarray(depth), CFG))
    assert np.array_equal(got2[:, :100], rgb[:, :100])
    assert not np.array_equal(got2[:, 110:], rgb[:, 110:])


def test_apply_effect_dispatch(rng):
    rgb, gray, depth = _case(rng, 24, 32)
    a = jnp.asarray(rgb)
    g = jnp.asarray(gray)
    d = jnp.asarray(depth)
    assert np.array_equal(np.asarray(effects.apply_effect(effects.EFFECT_NONE, a, g, d, CFG)), rgb)
    for eff, fn in [
        (effects.EFFECT_DEFOCUS, effects.defocus(a, d, CFG)),
        (effects.EFFECT_DESATURATION, effects.desaturation(a, g, d)),
        (effects.EFFECT_HAZE, effects.haze(a, d, CFG)),
    ]:
        assert np.array_equal(
            np.asarray(effects.apply_effect(eff, a, g, d, CFG)), np.asarray(fn)
        )


# --- Defocus quality='approx' (the 4K latency lever; config.py fields).
#     The approx output is EXACTLY the
#     defocus of the SNAPPED half field, so correctness splits into (a) snap
#     semantics and (b) per-pixel equality with exact wherever the snap is
#     the identity — out[p] depends only on half[p]. ---


def _approx_cfg(**kw):
    base = dict(
        pallas_defocus_quality="approx",
        pallas_defocus_exact_upto=16,
        pallas_defocus_stride=4,
    )
    base.update(kw)
    return DiffusionConfig(**base)


def test_snap_half_widths_semantics():
    """Halves <= exact_upto pass through; larger ones round to the nearest
    stride candidate (ties upward), clamped to the largest candidate;
    snapping is idempotent; 'exact' is the identity."""
    cfg = _approx_cfg()
    max_half = 55
    t, q = 16, 4
    cmax = t + (max_half - t) // q * q  # 52
    half = jnp.arange(0, max_half + 1, dtype=jnp.int32)
    got = np.asarray(effects.snap_half_widths(half, max_half, cfg))
    want = [
        hv if hv <= t else min(t + (hv - t + q // 2) // q * q, cmax)
        for hv in range(max_half + 1)
    ]
    assert got.tolist() == want
    # Every snapped value is a marched candidate (or 0 = no blur).
    cands = set(effects.defocus_candidates(max_half, cfg)) | {0}
    assert set(got.tolist()) <= cands
    # Idempotent: a snapped field passes through unchanged.
    again = np.asarray(effects.snap_half_widths(jnp.asarray(got), max_half, cfg))
    assert np.array_equal(again, got)
    # quality='exact' snaps nothing (the default 'auto' resolves to approx
    # at this 4K-regime max_half — covered by test_defocus_auto_quality_*).
    ident = np.asarray(effects.snap_half_widths(
        half, max_half, DiffusionConfig(pallas_defocus_quality="exact")
    ))
    assert np.array_equal(ident, np.asarray(half))


def test_defocus_candidates_approx_set():
    cfg = _approx_cfg()
    # 110 exact candidates at 4K (max_half 110) -> 16 exact + 23 coarse
    # (20, 24, ..., 108 — the largest candidate <= max_half).
    got = effects.defocus_candidates(110, cfg)
    assert got == list(range(1, 17)) + list(range(20, 111, 4))
    assert len(got) == 39
    # max_half below exact_upto: approx degenerates to the exact set.
    assert effects.defocus_candidates(9, cfg) == list(range(1, 10))


def test_defocus_approx_pointwise_vs_exact(rng):
    """Pixels whose half-width is already a candidate are BIT-IDENTICAL to
    the exact path (the approximation touches only snapped pixels), and the
    snapped pixels' error is a bounded window-size perturbation."""
    from realtimedepthdiffusion.core.effects import defocus_half_widths

    h, w = 140, 200
    cfg_a = _approx_cfg(defocus_aperture=0.5, pallas_defocus_exact_upto=8)
    # Pin exact explicitly: max_half 61 exceeds the 'auto' default's
    # threshold, which would silently make this arm approx too.
    cfg_e = DiffusionConfig(defocus_aperture=0.5,
                            pallas_defocus_quality="exact")  # max_half=61
    # Structured content (not noise): blur-mean differences survive.
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
    rgb[..., 1] = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
    rgb[40:70, 60:120] = (255, 0, 0)
    rgb[90:120, 20:180:7] = (0, 0, 255)
    depth = (rng.random((h, w), dtype=np.float32) * 255).astype(np.float32)
    exact = np.asarray(effects.defocus(jnp.asarray(rgb), jnp.asarray(depth), cfg_e)).astype(int)
    approx = np.asarray(effects.defocus(jnp.asarray(rgb), jnp.asarray(depth), cfg_a)).astype(int)

    half_e = np.asarray(defocus_half_widths(jnp.asarray(depth), h, w, cfg_e))
    half_a = np.asarray(defocus_half_widths(jnp.asarray(depth), h, w, cfg_a))
    same = half_e == half_a
    assert same.any() and not same.all()  # the case exercises both regimes
    assert np.array_equal(exact[same], approx[same])
    # Snapped pixels: half moved by <= stride/2 on windows >= exact_upto —
    # a small relative window perturbation; bound measured with margin.
    diff = np.abs(exact - approx)[~same]
    assert diff.max() <= 48
    assert float(np.sqrt((diff.astype(float) ** 2).mean())) < 8.0


def test_defocus_auto_quality_resolution(rng):
    """'auto' (the round-5 default): exact below the aperture threshold
    (bit-identical to quality='exact'), bounded-error approx above it
    (bit-identical to quality='approx'), with the switch resolved
    identically by every path through resolved_defocus_quality."""
    h, w = 64, 96
    rgb = jnp.asarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    depth = jnp.asarray((rng.random((h, w)) * 255).astype(np.float32))

    # Small aperture (max_half ~1 at 64x96): auto == exact.
    cfg_auto = DiffusionConfig()  # quality defaults to 'auto'
    assert cfg_auto.pallas_defocus_quality == "auto"
    k = cfg_auto.defocus_kernel_size(h, w)
    assert k // 2 <= cfg_auto.pallas_defocus_auto_max_half
    assert effects.resolved_defocus_quality(cfg_auto, k // 2) == "exact"
    got = np.asarray(effects.defocus(rgb, depth, cfg_auto))
    want = np.asarray(effects.defocus(
        rgb, depth, DiffusionConfig(pallas_defocus_quality="exact")
    ))
    assert np.array_equal(got, want)

    # Above the threshold (forced low): auto == approx, bitwise.
    cfg_low = DiffusionConfig(pallas_defocus_auto_max_half=0)
    assert effects.resolved_defocus_quality(cfg_low, k // 2) == "approx"
    got2 = np.asarray(effects.defocus(rgb, depth, cfg_low))
    want2 = np.asarray(effects.defocus(
        rgb, depth, DiffusionConfig(pallas_defocus_quality="approx")
    ))
    assert np.array_equal(got2, want2)

    # The regime boundary is the documented 4K contract: the 4K aperture
    # (2160x3840 -> max_half 55) resolves to approx, 1080p (27) to exact.
    assert effects.resolved_defocus_quality(
        cfg_auto, DiffusionConfig().defocus_kernel_size(2160, 3840) // 2
    ) == "approx"
    assert effects.resolved_defocus_quality(
        cfg_auto, DiffusionConfig().defocus_kernel_size(1080, 1920) // 2
    ) == "exact"

    # Validation: 'auto' accepts the approx knobs' constraints.
    import pytest
    with pytest.raises(ValueError, match="stride"):
        DiffusionConfig(pallas_defocus_quality="auto", pallas_defocus_stride=1)
    with pytest.raises(ValueError, match="quality"):
        DiffusionConfig(pallas_defocus_quality="exactish")


def test_defocus_auto_switch_is_loud(caplog):
    """The 'auto' -> approx switch is announced (a 4K user must not get an
    unlabeled approximation), exactly once per aperture regime."""
    import logging

    effects._AUTO_WARNED.clear()
    cfg = DiffusionConfig()
    with caplog.at_level(logging.WARNING, logger="realtimedepthdiffusion"):
        assert effects.resolved_defocus_quality(cfg, 55) == "approx"
    assert any(
        "approx" in r.getMessage() and "auto" in r.getMessage()
        for r in caplog.records
    ), caplog.records
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="realtimedepthdiffusion"):
        effects.resolved_defocus_quality(cfg, 55)  # same regime: silent
    assert not caplog.records
    effects._AUTO_WARNED.clear()
