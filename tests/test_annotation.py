"""Annotation ops: pyr-down priority semantics, seeding, painting, and the
annotation-PNG checkpoint round-trip."""

import numpy as np
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.core import annotation
from realtimedepthdiffusion.oracle import numpy_ref as oracle


def test_annotation_pyr_down_matches_oracle(rng):
    for shape, out in [((64, 96), (32, 48)), ((65, 97), (32, 48))]:
        mask = rng.random(shape) < 0.07
        val = rng.integers(0, 256, shape, dtype=np.uint8)
        om, ov = oracle.annotation_pyr_down(mask, val, out)
        jm, jv = annotation.annotation_pyr_down(jnp.asarray(mask), jnp.asarray(val), out)
        assert np.array_equal(om, np.asarray(jm))
        assert np.array_equal(ov, np.asarray(jv))


def test_annotation_pyr_down_last_writer_wins():
    """The 2x2 window is scanned row-major over {2y-1,2y}x{2x-1,2x}; the last
    masked pixel supplies the value (src/GPUImageProcessing.cu:33-44)."""
    mask = np.zeros((4, 4), bool)
    val = np.zeros((4, 4), np.uint8)
    # Coarse pixel (1,1) scans fine (1,1),(1,2),(2,1),(2,2) in that order.
    mask[1, 1] = True
    val[1, 1] = 10
    mask[2, 2] = True
    val[2, 2] = 99
    m, v = annotation.annotation_pyr_down(jnp.asarray(mask), jnp.asarray(val), (2, 2))
    assert bool(m[1, 1]) and int(v[1, 1]) == 99  # (2,2) wins over (1,1)
    # Only the earlier pixel:
    mask2 = np.zeros((4, 4), bool)
    val2 = np.zeros((4, 4), np.uint8)
    mask2[1, 1] = True
    val2[1, 1] = 10
    m2, v2 = annotation.annotation_pyr_down(jnp.asarray(mask2), jnp.asarray(val2), (2, 2))
    assert bool(m2[1, 1]) and int(v2[1, 1]) == 10


def test_annotation_pyr_down_monotone_mask(rng):
    """Coarse masks can only grow from fine masks (no scribble is lost unless
    the whole 2x2 window is empty)."""
    mask = rng.random((40, 40)) < 0.2
    val = rng.integers(0, 256, (40, 40), dtype=np.uint8)
    m, _ = oracle.annotation_pyr_down(mask, val, (20, 20))
    fine_any = np.zeros((20, 20), bool)
    for dy in (-1, 0):
        for dx in (-1, 0):
            ys = 2 * np.arange(20) + dy
            xs = 2 * np.arange(20) + dx
            ok = (ys >= 0)[:, None] & (xs >= 0)[None, :]
            fine_any |= mask[np.ix_(np.clip(ys, 0, 39), np.clip(xs, 0, 39))] & ok
    assert np.array_equal(m, fine_any)


def test_seed_depth():
    depth = np.full((5, 5), 255.0, np.float32)
    mask = np.zeros((5, 5), bool)
    mask[2, 2] = True
    val = np.zeros((5, 5), np.uint8)
    val[2, 2] = 64
    out = np.asarray(annotation.seed_depth(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(val)))
    assert out[2, 2] == 64.0 and out[0, 0] == 255.0
    assert np.array_equal(out, oracle.seed_depth(depth, mask, val))


def test_paint_square_brush(rng):
    mask = np.zeros((20, 30), bool)
    val = np.zeros((20, 30), np.uint8)
    jm, jv = annotation.paint(jnp.asarray(mask), jnp.asarray(val), 10, 8, 128, 5)
    om, ov = oracle.paint(mask, val, 10, 8, 128, 5)
    assert np.array_equal(om, np.asarray(jm))
    assert np.array_equal(ov, np.asarray(jv))
    # square of side 2*(5//2)+1 = 5 centered at (8,10)
    assert np.asarray(jm).sum() == 25
    assert bool(jm[8, 10]) and bool(jm[6, 8]) and not bool(jm[5, 10])
    # clipped at borders
    jm2, _ = annotation.paint(jnp.asarray(mask), jnp.asarray(val), 0, 0, 10, 5)
    assert np.asarray(jm2).sum() == 9


def test_annotation_png_roundtrip(tmp_path):
    from realtimedepthdiffusion.io import load_annotation, save_annotation

    rng = np.random.default_rng(3)
    mask = rng.random((31, 27)) < 0.3
    val = rng.choice([0, 64, 128, 192, 254], (31, 27)).astype(np.uint8)
    val = np.where(mask, val, 0).astype(np.uint8)
    p = str(tmp_path / "ann.png")
    save_annotation(p, mask, val)
    m2, v2 = load_annotation(p)
    assert np.array_equal(mask, m2)
    assert np.array_equal(val, v2)


def test_dataset_annotation_contract(dataset_pair):
    """Dataset annotations carry depths in {0,64,128,192,254} on scribbles
    (verified contract per SURVEY.md §4)."""
    _, mask, value = dataset_pair
    vals = np.unique(value[mask])
    assert set(vals.tolist()) <= {0, 64, 128, 192, 254}
    assert mask.any()
