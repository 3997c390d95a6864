"""Golden end-to-end test on a reference dataset pair (SURVEY.md §4): full
default-config solve, JAX vs NumPy oracle, RMSE <= 1e-3 (the BASELINE.json
accuracy bar), plus effect rendering on the result."""

import numpy as np
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import effects
from realtimedepthdiffusion.oracle import numpy_ref as oracle
from realtimedepthdiffusion.pipeline import DepthPipeline


@pytest.fixture(scope="module")
def solved(dataset_pair):
    rgb, mask, value = dataset_pair
    cfg = DiffusionConfig()
    h, w = rgb.shape[:2]
    pipe = DepthPipeline(h, w, cfg)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    depth, state = pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value), state)
    return rgb, mask, value, cfg, pipe, rgb_d, gpyr, np.asarray(depth)


def test_full_solve_rmse_vs_oracle(solved):
    rgb, mask, value, cfg, _, _, _, depth = solved
    gray = oracle.rgb_to_gray(rgb)
    want, _ = oracle.solve_pyramid(gray, mask, value, None, cfg)
    # Parity bar: RMSE <= 1e-3 on normalized [0,1] depth (BASELINE.json).
    rmse = float(np.sqrt(np.mean(((depth - want) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse


def test_depth_contract(solved):
    rgb, mask, value, cfg, pipe, _, _, depth = solved
    # Scribbles are honored exactly; the exported u8 map is in range.
    assert np.array_equal(depth[mask], value[mask].astype(np.float32))
    u8 = np.asarray(pipe.depth_u8(jnp.asarray(depth)))
    assert u8.dtype == np.uint8
    # A real annotation spans near and far: diffusion must produce a
    # nontrivial range between scribble extremes.
    assert u8.min() <= 64 and u8.max() >= 192


def test_effects_on_solved_depth(solved):
    rgb, mask, value, cfg, pipe, rgb_d, gpyr, depth = solved
    d = jnp.asarray(np.clip(depth, 0, 255))
    for eff in (effects.EFFECT_DEFOCUS, effects.EFFECT_DESATURATION, effects.EFFECT_HAZE):
        out = np.asarray(pipe.effect(eff, rgb_d, gpyr[0], d))
        assert out.shape == rgb.shape and out.dtype == np.uint8


@pytest.mark.parametrize(
    "name",
    [
        # One pair stays in the fast set as the breadth anchor; the heavier
        # two ride in the slow set.
        "StreetArt",
        pytest.param("Arara", marks=pytest.mark.slow),
        pytest.param("Flower", marks=pytest.mark.slow),
    ],
)
def test_more_dataset_pairs_light(name):
    """Broader dataset sweep at a reduced iteration budget: JAX vs oracle
    RMSE parity + scribble pinning on three more golden pairs."""
    import os

    img = f"/root/reference/dataset/images/{name}.jpg"
    ann = f"/root/reference/dataset/annotations/{name}.png"
    if not (os.path.exists(img) and os.path.exists(ann)):
        pytest.skip("reference dataset not mounted")
    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    rgb = imread_rgb(img)
    mask, value = load_annotation(ann)
    cfg = DiffusionConfig(max_iterations=120)
    gray = oracle.rgb_to_gray(rgb)
    want, _ = oracle.solve_pyramid(gray, mask, value, None, cfg)

    h, w = rgb.shape[:2]
    pipe = DepthPipeline(h, w, cfg)
    _, gpyr = pipe.prepare_image(rgb)
    depth, _ = pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state())
    depth = np.asarray(depth)
    rmse = float(np.sqrt(np.mean(((depth - want) / 255.0) ** 2)))
    assert rmse <= 1e-3, (name, rmse)
    assert np.array_equal(depth[mask], value[mask].astype(np.float32))


def test_golden_fingerprint_stability(solved):
    """Stored 32x32 mean-pooled fingerprint of the default-config Dog solve:
    catches silent co-drift of implementation AND oracle (which a relative
    comparison cannot see). Regenerate deliberately if semantics change:
    see tests/golden/."""
    import os

    path = os.path.join(os.path.dirname(__file__), "golden", "fingerprints", "Dog.npz")
    rgb, mask, value, cfg, pipe, _, _, depth = solved
    data = np.load(path)
    h, w = rgb.shape[:2]
    if not np.array_equal(data["shape"], [h, w]):
        pytest.skip("fingerprint was built for a different dataset variant")
    fh, fw = h // 32, w // 32
    fp = depth[: fh * 32, : fw * 32].reshape(32, fh, 32, fw).mean(axis=(1, 3))
    np.testing.assert_allclose(fp, data["fingerprint"], atol=1.0)
