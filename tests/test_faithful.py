"""CUDA-faithful parity (VERDICT r1 item 1).

Validates the faithful oracle's building blocks directly against OpenCV
(the reference binary's actual pyramid library) and the shipped pipeline
against the faithful oracle on dataset pairs. The full 12-pair table lives
in PARITY.md (regenerate with tools/parity_report.py).
"""

import os

import numpy as np
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.oracle import faithful
from realtimedepthdiffusion.oracle import numpy_ref as oracle

cv2 = pytest.importorskip("cv2")

RNG = np.random.default_rng(42)


def test_pyr_down_floor_is_cropped_opencv():
    """The framework's floor pyrDown equals cv::pyrDown's ceil output cropped
    to floor size — bit-exact (same fixed-point arithmetic), so the only
    gray-chain difference vs the binary is which array feeds the NEXT level."""
    for h, w in [(64, 64), (65, 63), (101, 77), (455, 455)]:
        g = RNG.integers(0, 256, (h, w), dtype=np.uint8)
        want = cv2.pyrDown(g)[: h // 2, : w // 2]
        got = oracle.pyr_down_gray(g)
        assert np.array_equal(got, want), (h, w)


def test_pyr_down_ceil_is_bitexact_opencv():
    """The faithful gray chain's pyrDown (oracle + JAX) == cv2.pyrDown."""
    from realtimedepthdiffusion.core import pyramid as jpyr

    for h, w in [(64, 64), (65, 63), (101, 77), (455, 455)]:
        g = RNG.integers(0, 256, (h, w), dtype=np.uint8)
        want = cv2.pyrDown(g)
        assert np.array_equal(oracle.pyr_down_gray_ceil(g), want), (h, w)
        assert np.array_equal(np.asarray(jpyr.pyr_down_gray_ceil(g)), want), (h, w)


def test_pyr_up_matches_opencv_all_parities():
    """oracle.pyr_up == cv::pyrUp(dstsize=...) for every odd/even target
    combination, including OpenCV's axis-asymmetric odd-size extension."""
    for (h, w), (oh, ow) in [
        ((32, 32), (64, 64)),
        ((32, 32), (65, 64)),
        ((32, 32), (64, 65)),
        ((32, 32), (65, 65)),
        ((51, 33), (102, 67)),
        ((51, 33), (103, 66)),
        ((113, 113), (227, 227)),
    ]:
        f = (RNG.random((h, w)).astype(np.float32)) * 255
        want = cv2.pyrUp(f, dstsize=(ow, oh))
        got = oracle.pyr_up(f, (oh, ow))
        assert np.abs(got - want).max() < 1e-3, ((h, w), (oh, ow))


def test_jax_pyr_up_matches_opencv():
    from realtimedepthdiffusion.core.pyramid import pyr_up as jpyr_up

    for (h, w), (oh, ow) in [((32, 32), (65, 65)), ((51, 33), (102, 67))]:
        f = (RNG.random((h, w)).astype(np.float32)) * 255
        want = cv2.pyrUp(f, dstsize=(ow, oh))
        got = np.asarray(jpyr_up(f, (oh, ow)))
        assert np.abs(got - want).max() < 1e-3, ((h, w), (oh, ow))


def test_faithful_cvtcolor_matches_oracle():
    bgr = RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    got = oracle.rgb_to_gray(bgr[..., ::-1])
    assert np.array_equal(got, want)


def _dataset(name):
    img = f"/root/reference/dataset/images/{name}.jpg"
    ann = f"/root/reference/dataset/annotations/{name}.png"
    if not (os.path.exists(img) and os.path.exists(ann)):
        pytest.skip("reference dataset not mounted")
    bgr = cv2.imread(img)
    plane = cv2.imread(ann, 0)
    mask = plane != 32
    value = np.where(mask, plane, 0).astype(np.uint8)
    return bgr, mask, value


# Arara exercises odd WIDTH levels (455/227/113), WomanParasol odd heights.
@pytest.mark.parametrize(
    "name",
    [
        # WomanParasol (odd heights) is the fast-set anchor; Arara (odd
        # widths) rides in the slow set.
        "WomanParasol",
        pytest.param("Arara", marks=pytest.mark.slow),
    ],
)
def test_pipeline_parity_vs_faithful_oracle(name):
    """The shipped JAX pipeline vs the CUDA-faithful oracle (real cv::pyrDown
    ceil-crop gray chain + cv::pyrUp): RMSE <= 1e-3 on normalized depth —
    the BASELINE.json north star measured against true reference numerics,
    not the shared-convention twin. Reduced iteration budget keeps CI fast;
    the full-schedule 12-pair table is PARITY.md."""
    import jax.numpy as jnp

    from realtimedepthdiffusion.pipeline import DepthPipeline

    bgr, mask, value = _dataset(name)
    cfg = DiffusionConfig(max_iterations=120)
    want, _ = faithful.solve_pyramid(bgr, mask, value, None, cfg)

    rgb = np.ascontiguousarray(bgr[..., ::-1])
    h, w = rgb.shape[:2]
    pipe = DepthPipeline(h, w, cfg)
    _, gpyr = pipe.prepare_image(rgb)
    depth, _ = pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state())
    depth = np.asarray(depth)
    rmse = float(np.sqrt(np.mean(((depth - want) / 255.0) ** 2)))
    assert rmse <= 1e-3, (name, rmse)
