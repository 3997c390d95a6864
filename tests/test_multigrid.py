"""Multigrid drivers: cascade vs oracle end-to-end, warm-start state,
V-cycle convergence."""

import numpy as np
import jax
import jax.numpy as jnp

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import multigrid, solver, weights
from realtimedepthdiffusion.oracle import numpy_ref as oracle
from tests.conftest import synthetic_pair


def _inputs(h=100, w=140, seed=5):
    rgb, mask, val = synthetic_pair(h, w, seed)
    gray = oracle.rgb_to_gray(rgb)
    return gray, mask, val


def test_cascade_matches_oracle():
    gray, mask, val = _inputs()
    cfg = DiffusionConfig(max_iterations=200)  # keep CPU runtime modest
    want, want_state = oracle.solve_pyramid(gray, mask, val, None, cfg)

    gp = multigrid.build_gray_pyramid(jnp.asarray(gray), cfg)
    st = multigrid.initial_depth_state(*gray.shape, cfg)
    got, got_state = multigrid.solve_cascade(gp, jnp.asarray(mask), jnp.asarray(val), st, cfg)
    # Parity bar: RMSE <= 1e-3 on normalized [0,1] depth (BASELINE.json).
    rmse = float(np.sqrt(np.mean(((np.asarray(got) - want) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        assert np.sqrt(np.mean(((np.asarray(a) - b) / 255.0) ** 2)) <= 1e-3


def test_cascade_warm_start_consistency():
    """A second solve from the returned state matches the oracle's second
    solve (the reference's persistent depth pyramid warm start)."""
    gray, mask, val = _inputs(80, 96, seed=9)
    cfg = DiffusionConfig(max_iterations=120)
    _, o_state = oracle.solve_pyramid(gray, mask, val, None, cfg)
    # add one more scribble and re-solve
    mask2, val2 = oracle.paint(mask, val, 48, 40, 192, 9)
    want2, _ = oracle.solve_pyramid(gray, mask2, val2, o_state, cfg)

    gp = multigrid.build_gray_pyramid(jnp.asarray(gray), cfg)
    st = multigrid.initial_depth_state(*gray.shape, cfg)
    _, j_state = multigrid.solve_cascade(gp, jnp.asarray(mask), jnp.asarray(val), st, cfg)
    got2, _ = multigrid.solve_cascade(gp, jnp.asarray(mask2), jnp.asarray(val2), j_state, cfg)
    rmse = float(np.sqrt(np.mean(((np.asarray(got2) - want2) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse


def test_scribbles_pinned_in_final_depth():
    gray, mask, val = _inputs()
    cfg = DiffusionConfig(max_iterations=200)
    gp = multigrid.build_gray_pyramid(jnp.asarray(gray), cfg)
    st = multigrid.initial_depth_state(*gray.shape, cfg)
    got, _ = multigrid.solve_cascade(gp, jnp.asarray(mask), jnp.asarray(val), st, cfg)
    got = np.asarray(got)
    assert np.array_equal(got[mask], val[mask].astype(np.float32))
    assert got.min() >= -30 and got.max() <= 285


def test_vcycle_reduces_residual_below_cascade():
    """The V-cycle extension must improve (or match) the cascadic residual at
    the finest level for the same pre-budget."""
    gray, mask, val = _inputs(96, 128, seed=11)
    cfg = DiffusionConfig(max_iterations=100)
    gp = multigrid.build_gray_pyramid(jnp.asarray(gray), cfg)
    m, v = jnp.asarray(mask), jnp.asarray(val)

    st = multigrid.initial_depth_state(*gray.shape, cfg)
    u_c, _ = multigrid.solve_cascade(gp, m, v, st, cfg)
    st = multigrid.initial_depth_state(*gray.shape, cfg)
    u_v, _ = multigrid.solve_vcycle(gp, m, v, st, cfg)

    # Evaluate both under the SAME operator (the warm-start weights the
    # V-cycle solves with): the depth-threshold weight rule re-derived from
    # each solution would change the operator and make residuals
    # incomparable.
    wts = weights.edge_weights(gp[0], u_c, 0, len(gp) - 1, cfg)
    r_c = float(solver.residual_norm(u_c, m, wts))
    r_v = float(solver.residual_norm(u_v, m, wts))
    assert r_v <= r_c * 1.05, (r_v, r_c)
    # And the two solutions agree on the converged field
    assert float(jnp.max(jnp.abs(u_v - u_c))) < 30.0


def test_cascade_jit_compiles_once():
    gray, mask, val = _inputs(64, 80, seed=2)
    cfg = DiffusionConfig(max_iterations=60)
    gp = multigrid.build_gray_pyramid(jnp.asarray(gray), cfg)
    fn = jax.jit(lambda g, m, v, s: multigrid.solve_cascade(g, m, v, s, cfg))
    st = multigrid.initial_depth_state(*gray.shape, cfg)
    d1, st1 = fn(gp, jnp.asarray(mask), jnp.asarray(val), st)
    d2, st2 = fn(gp, jnp.asarray(mask), jnp.asarray(val), st1)
    assert d1.shape == gray.shape and d2.shape == gray.shape
