"""On-card tests (marker ``gpu``): the coarse-level sweep kernel compiled
for the GPU through Triton, checked against XLA's sweeps on the same card.

They need an NVIDIA GPU and skip elsewhere; the fixture decides at run time.
``python chip_smoke.py`` runs them on the card (its phase d), as

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import solver
from realtimedepthdiffusion.core.weights import edge_weights
from realtimedepthdiffusion.ops import coarse_sweep, dispatch

pytestmark = pytest.mark.gpu

CFG = DiffusionConfig()


@pytest.fixture(scope="module")
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, JAX found {dev.platform!r}")
    return dev


@pytest.mark.parametrize("iters", [1, 11, 1000])
@pytest.mark.parametrize("shape", [(5, 3), (33, 60), (67, 120)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compiled_kernel_matches_xla(gpu, shape, iters):
    """Compiled kernel vs XLA's fori_loop sweeps on the card. The bounds are
    what multiply-add contraction, amplified by the Chebyshev extrapolation
    over 1000 sweeps, may change — not a difference in arithmetic (the
    interpreter agrees bit for bit over tens of sweeps)."""
    rng = np.random.default_rng(iters)
    h, w = shape
    gray = jnp.asarray(rng.integers(0, 256, shape, dtype=np.uint8))
    mask = jnp.asarray(rng.random(shape) < 0.05)
    depth = jnp.where(mask, 64.0, 255.0).astype(jnp.float32)
    wts = edge_weights(gray, depth, 1, 2, CFG)
    want = jax.jit(lambda d, m, *ws: solver.solve_jacobi_chebyshev(
        d, m, type(wts)(*ws), iters, CFG, early_exit=False))(depth, mask, *wts)
    got = jax.jit(lambda d, m, *ws: coarse_sweep.sweeps(
        d, m, type(wts)(*ws), iters, CFG))(depth, mask, *wts)
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) <= 1e-4
    assert np.abs(diff).max() <= 0.5


def test_route_takes_kernel_on_gpu(gpu):
    assert dispatch.route(gpu.platform, "level", "jacobi_chebyshev", "auto") == "kernel"
    assert dispatch.route(gpu.platform, "level", "jacobi_chebyshev", "pallas") == "kernel"
    assert dispatch.route(gpu.platform, "level", "red_black", "auto") == "xla"


def test_pipeline_with_kernel_matches_xla(gpu):
    """A 270x480 cascade (3 levels; the 67x120 coarsest takes the kernel):
    backend 'pallas' agrees with backend 'xla' under the parity bar."""
    from realtimedepthdiffusion.pipeline import DepthPipeline

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (270, 480, 3), dtype=np.uint8)
    mask = np.zeros((270, 480), bool)
    mask[40:60, 50:90] = True
    mask[200:230, 380:420] = True
    value = np.where(mask, 64, 0).astype(np.uint8)
    value[200:230, 380:420] = 254
    out = {}
    for backend in ("xla", "pallas"):
        cfg = DiffusionConfig(backend=backend, fast_start=False)
        pipe = DepthPipeline(270, 480, cfg)
        _, gpyr = pipe.prepare_image(rgb)
        d, _ = pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value),
                          pipe.initial_state())
        out[backend] = np.asarray(d)
    rmse = np.sqrt(np.mean(((out["pallas"] - out["xla"]) / 255.0) ** 2))
    assert rmse <= 1e-4, rmse
    assert np.array_equal(out["pallas"][mask], value[mask].astype(np.float32))
