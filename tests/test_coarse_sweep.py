"""The coarse-level sweep kernel (ops/coarse_sweep.py) under the Pallas
interpreter, its layout and fit rule, and the route table (ops/dispatch.py)
that decides where it runs. The compiled kernel runs in tests/test_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import solver
from realtimedepthdiffusion.core.weights import edge_weights
from realtimedepthdiffusion.ops import coarse_sweep, dispatch

CFG = DiffusionConfig()


def _level(h, w, seed=0, level=1, max_level=2):
    rng = np.random.default_rng(seed)
    gray = jnp.asarray(rng.integers(0, 256, (h, w), dtype=np.uint8))
    mask = rng.random((h, w)) < 0.05
    depth = np.where(mask, rng.integers(0, 255, (h, w)), 255.0)
    depth, mask = jnp.asarray(depth, jnp.float32), jnp.asarray(mask)
    return depth, mask, edge_weights(gray, depth, level, max_level, CFG)


@pytest.mark.parametrize("iters", [1, 10, 11, 25])  # S = 10: around the switch
@pytest.mark.parametrize(
    "shape",
    [(7, 9), (31, 17), (33, 60), (67, 120)],
    ids=lambda s: f"{s[0]}x{s[1]}",
)
def test_kernel_matches_xla_solver(shape, iters):
    """Interpret-mode kernel == core.solver.solve_jacobi_chebyshev (same
    arithmetic, term for term), on odd sizes, the 1080p/4K coarsest level
    (67x120) and the level above it at 540p (33x60)."""
    depth, mask, wts = _level(*shape, seed=iters)
    want = solver.solve_jacobi_chebyshev(depth, mask, wts, iters, CFG,
                                         early_exit=False)
    got = jax.jit(
        lambda d, m, w: coarse_sweep.sweeps(d, m, w, iters, CFG, interpret=True)
    )(depth, mask, wts)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-4)
    assert np.array_equal(np.asarray(got)[np.asarray(mask)],
                          np.asarray(depth)[np.asarray(mask)])


@pytest.mark.parametrize("win", [192, 384], ids=lambda w: f"window{w}")
def test_kernel_matches_xla_on_incremental_window_levels(win):
    """The incremental path's window levels (384 at L0, 192 at L1) with the
    frozen border ring: the kernel computes them right even though the fit
    rule keeps them on XLA."""
    depth, mask, _ = _level(win, win, seed=win)
    yy, xx = np.indices((win, win))
    ring = (yy == 0) | (yy == win - 1) | (xx == 0) | (xx == win - 1)
    mask = mask | jnp.asarray(ring)
    rng = np.random.default_rng(1)
    wts = edge_weights(jnp.asarray(rng.integers(0, 256, (win, win), dtype=np.uint8)),
                       depth, 0, 4, CFG)
    want = solver.solve_jacobi_chebyshev(depth, mask, wts, 12, CFG, early_exit=False)
    got = coarse_sweep.sweeps(depth, mask, wts, 12, CFG, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-4)


def test_kernel_zero_iterations_is_identity():
    depth, mask, wts = _level(9, 13)
    got = coarse_sweep.sweeps(depth, mask, wts, 0, CFG, interpret=True)
    assert np.array_equal(np.asarray(got), np.asarray(depth))


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (67, 120)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pack_layout(shape):
    """pack/unpack round-trip, the power-of-two span, and the zero border:
    the zero column and the rows above/below the level stay at the fill."""
    h, w = shape
    s, n, length = coarse_sweep.layout(h, w)
    assert s == w + 1 and n >= h * s and n & (n - 1) == 0 and length == n + 2 * s
    plane = jnp.arange(1, h * w + 1, dtype=jnp.float32).reshape(h, w)
    flat = coarse_sweep.pack(plane)
    assert flat.shape == (length,)
    assert np.array_equal(np.asarray(coarse_sweep.unpack(flat, h, w)), np.asarray(plane))
    f = np.asarray(flat)
    assert not f[:s].any() and not f[s + h * s:].any()
    assert not f[s : s + h * s].reshape(h, s)[:, 0].any()
    pinned = np.asarray(coarse_sweep.pack(jnp.zeros((h, w), jnp.int32), fill=1))
    assert pinned[s : s + n].sum() == n - h * w  # everything but real pixels


@pytest.mark.parametrize(
    "shape, fits",
    [
        ((67, 120), True),     # 1080p and 4K coarsest level: n = 8192
        ((33, 60), True),
        ((8, 8), True),
        ((135, 240), False),   # next level up: n = 32768
        ((96, 160), False),    # n = 16384: 512 KB of live planes
        ((384, 384), False),   # incremental window
    ],
)
def test_fit_rule(shape, fits):
    """A level fits when LIVE_PLANES f32 planes of its span fit the SM's
    register file plus its 227 KB of L1/shared memory."""
    _, n, _ = coarse_sweep.layout(*shape)
    assert coarse_sweep.fits(*shape) is fits
    budget = coarse_sweep.SM_REGISTER_BYTES + coarse_sweep.SM_SHARED_BYTES
    assert (n * coarse_sweep.LIVE_PLANES * 4 <= budget) is fits


@pytest.mark.parametrize("shape, warps", [((7, 9), 4), ((33, 60), 8), ((67, 120), 32)])
def test_num_warps(shape, warps):
    assert coarse_sweep.num_warps(*shape) == warps


def _expected_route(platform, op, solver_name, backend, early_exit):
    """The route table written out by hand (ops/dispatch.py docstring)."""
    has_kernel = op == "level" and platform == "gpu"
    if backend == "xla":
        return "xla"
    if backend == "pallas" and not has_kernel:
        return ValueError
    if backend == "pallas_interpret" and op != "level":
        return ValueError
    if solver_name != "jacobi_chebyshev" or early_exit:
        return "xla"
    if backend == "pallas_interpret":
        return "interpret"
    return "kernel" if has_kernel else "xla"


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early_exit"])
@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "jacobi", "red_black"])
@pytest.mark.parametrize("backend", dispatch.VALID_BACKENDS)
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_route_table_level(platform, backend, solver_name, early_exit):
    want = _expected_route(platform, "level", solver_name, backend, early_exit)
    if want is ValueError:
        with pytest.raises(ValueError, match="no 'level' kernel on platform"):
            dispatch.route(platform, "level", solver_name, backend, early_exit)
    else:
        assert dispatch.route(platform, "level", solver_name, backend, early_exit) == want


@pytest.mark.parametrize("backend", dispatch.VALID_BACKENDS)
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_route_table_sharded(platform, backend):
    """The sharded solve has no kernel anywhere: auto/xla take XLA, the
    kernel backends raise."""
    want = _expected_route(platform, "sharded", "jacobi_chebyshev", backend, False)
    if want is ValueError:
        with pytest.raises(ValueError, match="kernel"):
            dispatch.route(platform, "sharded", "jacobi_chebyshev", backend)
    else:
        assert dispatch.route(platform, "sharded", "jacobi_chebyshev", backend) == want


def test_route_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.route("gpu", "level", "jacobi_chebyshev", "mosaic")


@pytest.mark.parametrize("shape, takes_kernel", [((67, 120), True), ((135, 240), False)])
def test_solve_level_applies_fit_rule(monkeypatch, shape, takes_kernel):
    """On the interpret route, a level that does not fit one CTA stays on
    XLA; one that fits goes to the kernel."""
    calls = []
    real = coarse_sweep.solve_level
    monkeypatch.setattr(coarse_sweep, "solve_level",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    cfg = DiffusionConfig(backend="pallas_interpret")
    depth, mask, _ = _level(*shape)
    gray = jnp.zeros(shape, jnp.uint8)
    out = jax.eval_shape(
        lambda d, m, g: dispatch.solve_level(d, m, g, 0, 0, 3, cfg), depth, mask, gray
    )
    assert out.shape == shape
    assert bool(calls) is takes_kernel
    if takes_kernel:
        assert calls[0]["interpret"] is True


def test_pallas_backend_raises_on_cpu():
    """backend='pallas' on a platform without the kernel fails loudly at the
    first solve instead of falling back to XLA."""
    from realtimedepthdiffusion.pipeline import DepthPipeline

    cfg = DiffusionConfig(backend="pallas", max_iterations=8)
    pipe = DepthPipeline(32, 48, cfg)
    _, gpyr = pipe.prepare_image(np.zeros((32, 48, 3), np.uint8))
    m = jnp.zeros((32, 48), bool)
    with pytest.raises(ValueError, match="no 'level' kernel on platform 'cpu'"):
        pipe.solve(gpyr, m, m.astype(jnp.uint8), pipe.initial_state())
