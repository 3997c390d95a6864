"""Localized incremental re-solve (core/incremental.py): convergence parity
vs the full re-solve, scribble pinning, and the session's dirty-window
upload path."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.pipeline import DepthPipeline
from tests.conftest import synthetic_pair


def _solve_pair(rgb, m0, v0, cfg):
    h, w = rgb.shape[:2]
    pipe = DepthPipeline(h, w, cfg)
    _, gp = pipe.prepare_image(rgb)
    d0, st = pipe.solve(gp, jnp.asarray(m0), jnp.asarray(v0), pipe.initial_state())
    return pipe, gp, d0, st


def test_incremental_parity_dataset():
    """Realistic live-editing scenario (extend an existing stroke on a dense
    dataset annotation): the windowed incremental solve must track the full
    warm re-solve closely — measured 1.0e-2 normalized RMSE; bound 2e-2.
    (For reference, the round-1 budget-120 full-cascade incremental measures
    2.0e-2 on the same case while doing ~8x the fine-level work.)"""
    img = "/root/reference/dataset/images/Dog.jpg"
    ann = "/root/reference/dataset/annotations/Dog.png"
    if not (os.path.exists(img) and os.path.exists(ann)):
        pytest.skip("reference dataset not mounted")
    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    rgb = imread_rgb(img)
    m0, v0 = load_annotation(ann)
    cfg = DiffusionConfig(incremental_iterations=120)
    pipe, gp, _, st = _solve_pair(rgb, m0, v0, cfg)

    ys, xs = np.nonzero(m0)
    cy, cx = int(ys[len(ys) // 2]), int(xs[len(xs) // 2])
    val = int(v0[cy, cx])
    m2, v2 = m0.copy(), v0.copy()
    m2[cy + 15 : cy + 35, cx + 15 : cx + 35] = True
    v2[cy + 15 : cy + 35, cx + 15 : cx + 35] = val
    center = jnp.asarray([cy + 25, cx + 25], jnp.int32)

    d_inc, _ = pipe.solve_incremental(
        gp, jnp.asarray(m2), jnp.asarray(v2), tuple(jnp.array(s) for s in st), center
    )
    d_full, _ = pipe.solve(
        gp, jnp.asarray(m2), jnp.asarray(v2), tuple(jnp.array(s) for s in st)
    )
    d_inc, d_full = np.asarray(d_inc), np.asarray(d_full)
    rmse = float(np.sqrt(np.mean(((d_inc - d_full) / 255.0) ** 2)))
    assert rmse <= 2e-2, rmse
    assert np.array_equal(d_inc[m2], v2[m2].astype(np.float32))


@pytest.mark.slow
def test_incremental_parity_synthetic_sparse():
    """Worst-case: ultra-sparse annotations (0.4% coverage) where one new
    scribble rebalances the whole harmonic field. The localized solve's
    far-field comes from the full coarse re-solves' pyrUp'd delta — injected
    into the NON-windowed levels' warm starts too (the round-4 fix; without
    it this case measured 4.8e-2 and dataset island strokes up to 0.12).
    Measured 1.5e-2; ledger worst across 39 pair/stroke cases is 2.6e-2
    (tools/incremental_report.py, PERF.md round-4 table); bound 3e-2."""
    rgb, m0, v0 = synthetic_pair(420, 560, 7)
    cfg = DiffusionConfig(incremental_iterations=120)
    pipe, gp, _, st = _solve_pair(rgb, m0, v0, cfg)

    m2, v2 = m0.copy(), v0.copy()
    m2[290:310, 390:410] = True
    v2[290:310, 390:410] = 64
    center = jnp.asarray([300, 400], jnp.int32)

    d_inc, state2 = pipe.solve_incremental(
        gp, jnp.asarray(m2), jnp.asarray(v2), tuple(jnp.array(s) for s in st), center
    )
    d_full, _ = pipe.solve(
        gp, jnp.asarray(m2), jnp.asarray(v2), tuple(jnp.array(s) for s in st)
    )
    d_inc, d_full = np.asarray(d_inc), np.asarray(d_full)
    rmse = float(np.sqrt(np.mean(((d_inc - d_full) / 255.0) ** 2)))
    assert rmse <= 3e-2, rmse
    assert np.array_equal(d_inc[m2], v2[m2].astype(np.float32))
    # the state pyramid is consistent (level 0 of the state IS the output)
    assert np.array_equal(np.asarray(state2[0]), d_inc)


def test_session_dirty_window_upload():
    """A small paint stroke takes the local path: the device annotation
    planes are updated through the window upload (not a full re-transfer)
    and end up exactly equal to the host planes; the solve is pinned."""
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, _, _ = synthetic_pair(128, 160, 5)
    cfg = DiffusionConfig(max_iterations=40, incremental_iterations=16,
                          incremental_window=64)
    s = DepthSession(rgb, cfg)
    s.set_color_key(1)
    s.paint(40, 40)
    s.solve()  # first solve: full path
    assert s.solve_count == 1

    s.set_color_key(3)
    s.paint(100, 90)
    rect = s.dirty
    assert rect is not None and rect[2] - rect[0] + 1 <= 64
    s.solve()  # local path: window upload + windowed re-solve
    assert np.array_equal(
        np.asarray(s._mask_d), s.mask_np.astype(bool)
    )
    assert np.array_equal(np.asarray(s._value_d), s.value_np)
    d = np.asarray(s.depth0)
    assert d[90, 100] == 192.0  # new scribble pinned (color key 3)


def test_session_window_covers_rect_spanning_exactly_window():
    """Regression: a dirty rect spanning EXACTLY the window size used to get
    a center-derived window missing its last row/column, silently dropping
    painted pixels from the device upload (and clearing the dirty flag)."""
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, _, _ = synthetic_pair(128, 160, 5)
    cfg = DiffusionConfig(max_iterations=40, incremental_iterations=16,
                          incremental_window=64)
    s = DepthSession(rgb, cfg)
    s.set_color_key(1)
    s.paint(40, 40)
    s.solve()
    # Union dirty rect rows [32, 95]: height exactly 64 == window.
    s.scribble_radius = 0
    s.set_color_key(4)
    s.paint(40, 32)
    s.paint(40, 95)
    assert s.dirty[2] - s.dirty[0] + 1 == 64
    s.solve()
    assert np.array_equal(np.asarray(s._mask_d), s.mask_np.astype(bool))
    assert np.asarray(s.depth0)[95, 40] == 254.0


def test_incremental_full_fallback_on_large_edit():
    """An edit larger than the window (annotation load) falls back to the
    full path and still lands the right device state."""
    from realtimedepthdiffusion.live.session import DepthSession
    from realtimedepthdiffusion.io import save_annotation

    rgb, m0, v0 = synthetic_pair(128, 160, 6)
    cfg = DiffusionConfig(max_iterations=40, incremental_iterations=16,
                          incremental_window=64)
    s = DepthSession(rgb, cfg)
    s.paint(80, 64)
    s.solve()
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "a.png")
        save_annotation(p, m0, v0, cfg)
        s.load_annotation_file(p)  # full-plane dirty rect
        s.solve()
    assert np.array_equal(np.asarray(s._mask_d), s.mask_np.astype(bool))


def test_session_multi_rect_incremental():
    """Two SIMULTANEOUS distant strokes each take the windowed incremental
    path (round-4 verdict task #5 — the single bounding rect used to
    overflow the window and silently fall back to the full re-solve):
    paint() keeps them as separate dirty rects, solve() window-solves each
    sequentially through the same compiled program, and the result tracks
    a full warm re-solve within the ledger band."""
    from realtimedepthdiffusion.live.session import DepthSession
    from realtimedepthdiffusion.pipeline import DepthPipeline

    rgb, _, _ = synthetic_pair(192, 224, 5)
    cfg = DiffusionConfig(max_iterations=60, incremental_iterations=16,
                          incremental_window=64)
    s = DepthSession(rgb, cfg)
    s.set_color_key(1)
    s.paint(40, 40)
    s.solve()
    mask1 = s.mask_np.astype(bool).copy()
    value1 = s.value_np.copy()

    # Two distant strokes in the same frame: far beyond one 64px window.
    s.set_color_key(3)
    s.paint(30, 30)
    s.set_color_key(4)
    s.paint(190, 160)
    assert len(s.dirty_rects) == 2
    bb = s.dirty
    assert bb[2] - bb[0] + 1 > 64 or bb[3] - bb[1] + 1 > 64  # union overflows

    calls = []
    real = s.pipe.solve_incremental
    s.pipe.solve_incremental = (
        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    )
    s.solve()
    assert len(calls) == 2, "each rect must take the incremental path"
    # Device planes carry BOTH windows.
    assert np.array_equal(np.asarray(s._mask_d), s.mask_np.astype(bool))
    d = np.asarray(s.depth0)
    assert d[30, 30] == 192.0 and d[160, 190] == 254.0  # both pinned

    # Quality: track a full warm re-solve from the same warm trajectory
    # (first-solve state from the first annotation, then both strokes).
    pipe = DepthPipeline(192, 224, DiffusionConfig(max_iterations=60))
    _, gp = pipe.prepare_image(rgb)
    _, st = pipe.solve(
        gp, jnp.asarray(mask1), jnp.asarray(value1), pipe.initial_state()
    )
    d_full, _ = pipe.solve(
        gp, jnp.asarray(s.mask_np.astype(bool)), jnp.asarray(s.value_np), st
    )
    rmse = float(np.sqrt(np.mean(((d - np.asarray(d_full)) / 255.0) ** 2)))
    assert rmse <= 3e-2, rmse


def test_session_rect_overflow_merges_nearest():
    """More simultaneous rects than cfg.incremental_max_rects: the nearest
    pairs merge, the list stays bounded, and solve still succeeds."""
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, _, _ = synthetic_pair(192, 224, 6)
    cfg = DiffusionConfig(max_iterations=40, incremental_iterations=16,
                          incremental_window=64, incremental_max_rects=2)
    s = DepthSession(rgb, cfg)
    s.set_color_key(2)
    s.paint(40, 40)
    s.solve()
    for (x, y) in ((20, 20), (200, 30), (30, 170), (200, 170)):
        s.paint(x, y)
    assert len(s.dirty_rects) <= 2
    s.solve()
    d = np.asarray(s.depth0)
    yy, xx = np.nonzero(s.mask_np)
    assert np.array_equal(d[yy, xx], s.value_np[yy, xx].astype(np.float32))
