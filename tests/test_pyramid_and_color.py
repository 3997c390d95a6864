"""Pyramid + color ops: JAX vs NumPy oracle, and vs OpenCV where the
conventions coincide (even sizes)."""

import numpy as np
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.core import pyramid
from realtimedepthdiffusion.core.color import rgb_to_gray
from realtimedepthdiffusion.oracle import numpy_ref as oracle


def test_rgb_to_gray_matches_oracle(rng):
    rgb = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    assert np.array_equal(
        np.asarray(rgb_to_gray(jnp.asarray(rgb))), oracle.rgb_to_gray(rgb)
    )


def test_rgb_to_gray_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    rgb = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    bgr = rgb[..., ::-1].copy()
    expect = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    assert np.array_equal(oracle.rgb_to_gray(rgb), expect)


@pytest.mark.parametrize("shape", [(64, 96), (65, 97), (45, 46)])
def test_pyr_down_gray_matches_oracle(rng, shape):
    g = rng.integers(0, 256, shape, dtype=np.uint8)
    got = np.asarray(pyramid.pyr_down_gray(jnp.asarray(g)))
    want = oracle.pyr_down_gray(g)
    assert got.shape == (shape[0] // 2, shape[1] // 2)
    assert np.array_equal(got, want)


def test_pyr_down_matches_opencv_even(rng):
    """For even sizes our floor convention equals OpenCV's ceil convention,
    so the reference's cv::pyrDown chain (src/main.cpp:112) is reproduced
    exactly."""
    cv2 = pytest.importorskip("cv2")
    g = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    want = cv2.pyrDown(g)
    got = oracle.pyr_down_gray(g)
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "src_shape,target",
    [((32, 48), (64, 96)), ((32, 48), (65, 97)), ((31, 47), (62, 95)), ((31, 47), (63, 94))],
)
def test_pyr_up_matches_oracle(rng, src_shape, target):
    src = (rng.random(src_shape, dtype=np.float32) * 255).astype(np.float32)
    got = np.asarray(pyramid.pyr_up(jnp.asarray(src), target))
    want = oracle.pyr_up(src, target)
    assert got.shape == target
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pyr_up_matches_opencv_even(rng):
    cv2 = pytest.importorskip("cv2")
    src = (rng.random((32, 48), dtype=np.float32) * 255).astype(np.float32)
    want = cv2.pyrUp(src)
    got = oracle.pyr_up(src, (64, 96))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_pyr_up_constant_preserved():
    """A constant field must be reproduced exactly (partition of unity)."""
    src = np.full((20, 30), 127.5, np.float32)
    up = oracle.pyr_up(src, (40, 61))
    np.testing.assert_allclose(up, 127.5, atol=1e-4)
