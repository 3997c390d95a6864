"""Edge weights + solver: unit tests vs the NumPy oracle and the property
tests SURVEY.md §4 prescribes (Dirichlet invariance, clamping, convergence)."""

import numpy as np
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import solver, weights
from realtimedepthdiffusion.oracle import numpy_ref as oracle

CFG = DiffusionConfig()


def _case(rng, h=48, w=64):
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)
    return gray, mask, val, depth


@pytest.mark.parametrize("level,max_level", [(2, 2), (1, 2), (0, 2), (0, 0)])
def test_edge_weights_match_oracle(rng, level, max_level):
    gray, _, _, depth = _case(rng)
    depth = depth + rng.normal(0, 3, depth.shape).astype(np.float32)
    ow = oracle.edge_weights(gray, depth, level, max_level, CFG)
    jw = weights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), level, max_level, CFG)
    for o, j in zip(ow, (jw.wl, jw.wr, jw.wu, jw.wd)):
        np.testing.assert_allclose(np.asarray(j), o, atol=1e-7)


def test_edge_weight_values_and_borders(rng):
    """w = exp(-beta*|dg|) (the LUT of src/GPUSolver.cu:264-272), zero at the
    image border (sentinel index 256)."""
    gray = np.array([[0, 10], [20, 30]], np.uint8)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    assert np.all(np.asarray(jw.wl)[:, 0] == 0)
    assert np.all(np.asarray(jw.wr)[:, -1] == 0)
    assert np.all(np.asarray(jw.wu)[0, :] == 0)
    assert np.all(np.asarray(jw.wd)[-1, :] == 0)
    np.testing.assert_allclose(
        float(jw.wr[0, 0]), np.exp(np.float32(-0.4) * 10), rtol=1e-6
    )


def test_depth_threshold_rule():
    """Finer levels: weight 1.0 where upsampled (uint8-truncated) depth is
    smooth (|diff| <= 4), else the gray weight; threshold 0 at level 0
    (src/GPUSolver.cu:196-220)."""
    gray = np.array([[0, 100], [0, 100]], np.uint8)
    depth = np.array([[10.0, 13.9], [10.0, 20.0]], np.float32)  # u8: 10,13 / 10,20
    jw = weights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), 1, 2, CFG)
    assert float(jw.wr[0, 0]) == 1.0  # |10-13| <= 4 -> free diffusion
    np.testing.assert_allclose(
        float(jw.wr[1, 0]), np.exp(np.float32(-0.4) * 100), rtol=1e-6
    )  # |10-20| > 4 -> gray weight
    # level 0: threshold 0, so |10-13| > 0 -> gray weight
    jw0 = weights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), 0, 2, CFG)
    np.testing.assert_allclose(
        float(jw0.wr[0, 0]), np.exp(np.float32(-0.4) * 100), rtol=1e-6
    )


def test_chebyshev_omegas():
    om = solver.chebyshev_omegas(15, CFG)
    assert np.array_equal(om, oracle.chebyshev_omegas(15, CFG))
    assert np.all(om[:10] == 1.0)
    np.testing.assert_allclose(om[10], 2.0 / (2.0 - 0.99**2), rtol=1e-6)
    np.testing.assert_allclose(om[11], 4.0 / (4.0 - 0.99**2 * om[10]), rtol=1e-6)
    # The schedule converges to the SOR-like fixed point ~1.7527
    om_long = solver.chebyshev_omegas(200, CFG)
    np.testing.assert_allclose(om_long[-1], 1.7527, atol=1e-3)


def test_single_sweep_matches_oracle(rng):
    gray, mask, val, depth = _case(rng)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    ow = oracle.edge_weights(gray, None, 1, 1, CFG)
    inv = np.asarray(jw.inv_count)
    got = np.asarray(solver.jacobi_sweep(jnp.asarray(depth), jw))
    want = oracle.jacobi_sweep(depth, *ow, inv)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_solve_level_matches_oracle(rng):
    """XLA vs NumPy accumulate ~1-ulp/sweep rounding differences that the
    marginally-stable Chebyshev recurrence amplifies in near-null smooth
    modes, so tolerance grows with the iteration count; the normalized
    ([0,1]-scale) RMSE stays orders of magnitude under the 1e-3 parity bar
    (see test_multigrid/test_golden)."""
    gray, mask, val, depth = _case(rng)
    for iters, atol in ((1, 1e-3), (11, 5e-3), (60, 5e-2)):
        got = np.asarray(
            solver.solve_level(
                jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, iters, CFG
            )
        )
        want = oracle.solve_level(depth, mask, gray, 1, 1, iters, CFG)
        np.testing.assert_allclose(got, want, atol=atol)


def test_dirichlet_pixels_immutable(rng):
    """Scribbled pixels keep their seeded value through any number of sweeps
    (the early return at src/GPUSolver.cu:248)."""
    gray, mask, val, depth = _case(rng)
    out = np.asarray(
        solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 100, CFG
        )
    )
    assert np.array_equal(out[mask], depth[mask])


def test_inner_average_clamped_outer_not(rng):
    """The Jacobi average clamps to [0,255]; brief Chebyshev overshoot
    outside the range is legal (src/GPUSolver.cu:104 vs :259) but bounded."""
    gray, mask, val, depth = _case(rng)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    avg = np.asarray(solver.jacobi_sweep(jnp.asarray(depth), jw))
    assert avg.min() >= 0.0 and avg.max() <= 255.0
    out = np.asarray(
        solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 200, CFG
        )
    )
    assert out.min() >= -30.0 and out.max() <= 285.0  # bounded overshoot


def test_isolated_pixel_rule():
    """count == 0 (all weights absent) yields 0 (src/GPUSolver.cu:103):
    realizable only on a 1x1 image."""
    gray = np.array([[7]], np.uint8)
    depth = np.array([[200.0]], np.float32)
    mask = np.array([[False]])
    out = np.asarray(
        solver.solve_level(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 0, 0, 1, CFG)
    )
    # result = 0; chebyshev: omega=1,gamma=.99,prev=0: 0.99*(0-200)+200 = 2.0
    np.testing.assert_allclose(out[0, 0], 2.0, atol=1e-4)


def test_convergence_residual_decreases(rng):
    gray, mask, val, depth = _case(rng)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    res = []
    for iters in (10, 100, 400):
        u = solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, iters, CFG
        )
        res.append(float(solver.residual_norm(u, jnp.asarray(mask), jw)))
    assert res[2] < res[1] < res[0]
    assert res[2] < 0.5  # near-converged after 400 chebyshev sweeps


def test_red_black_matches_oracle_and_converges(rng):
    import math

    gray, mask, val, depth = _case(rng, 32, 40)
    # Grid-matched rho for the SOR parity case: the default 0.9999 is deep
    # in its overestimate transient at 32x40 and the amplified FMA
    # random-walk would swamp the comparison.
    cfg = DiffusionConfig(rb_rho=math.cos(math.pi / 40))
    got = np.asarray(
        solver.solve_red_black(
            jnp.asarray(depth),
            jnp.asarray(mask),
            weights.edge_weights(jnp.asarray(gray), None, 1, 1, cfg),
            40,
            cfg,
            early_exit=False,
        )
    )
    want = oracle.solve_level_red_black(depth, mask, gray, 1, 1, 40, cfg)
    # The omega schedule itself must agree BIT-exactly (independent
    # derivations of the Golub-Varga recurrence).
    np.testing.assert_array_equal(
        solver.rb_omegas(40, cfg), oracle.rb_omegas(40, cfg)
    )
    # Iterate parity: the SOR extrapolation (omega -> ~1.75) random-walks
    # per-iteration XLA-vs-numpy FMA noise (measured ~2.7e-4/iteration at
    # this size); 40 iterations stay within 2e-2 on the 0-255 scale, and
    # the plain-GS sub-case (rb_chebyshev=False) keeps the old tight band.
    np.testing.assert_allclose(got, want, atol=2e-2)
    cfg_gs = DiffusionConfig(rb_chebyshev=False)
    got_gs = np.asarray(
        solver.solve_red_black(
            jnp.asarray(depth),
            jnp.asarray(mask),
            weights.edge_weights(jnp.asarray(gray), None, 1, 1, cfg_gs),
            40,
            cfg_gs,
            early_exit=False,
        )
    )
    want_gs = oracle.solve_level_red_black(depth, mask, gray, 1, 1, 40, cfg_gs)
    np.testing.assert_allclose(got_gs, want_gs, atol=2e-3)


def test_rb_omega_schedule_properties():
    """Machinery of the cyclic-Chebyshev schedule: plain warm-up for the
    first S half-sweeps, then monotone DECREASE from 2/(2-rho^2) toward the
    optimal-SOR asymptote 2/(1+sqrt(1-rho^2)), never reaching 2 (SOR
    stability)."""
    import math

    cfg = DiffusionConfig()
    om = solver.rb_omegas(100, cfg).ravel()  # half-sweep order
    s = cfg.chebyshev_s
    assert np.all(om[:s] == 1.0)
    tail = om[s:]
    assert np.all(np.diff(tail) <= 0)
    limit = 2.0 / (1.0 + math.sqrt(1.0 - cfg.rb_rho**2))
    assert np.all(tail < 2.0)
    np.testing.assert_allclose(tail[-1], limit, rtol=1e-3)
    # Disabled -> all ones (plain Gauss-Seidel).
    assert np.all(solver.rb_omegas(50, DiffusionConfig(rb_chebyshev=False)) == 1.0)


@pytest.mark.slow
def test_rb_beats_jacobi_quality_on_real_pair():
    """The shipped config #2 claim: on a real dataset pair at FULL
    resolution with the shipped operating point (tol 1e-3, RMS metric),
    red-black + cyclic-Chebyshev + early exit reaches AT LEAST the solution
    quality of the reference Jacobi-Chebyshev schedule (RMSE against an
    8x-converged truth). Full resolution matters: at half scale the pyramid
    is one level shorter and the same tolerance exits relatively earlier,
    flipping the comparison — the claim is about the shipped geometry. The
    wall-clock half of the claim is measured on hardware
    (tools/rb_vs_jacobi.py, PERF.md round-3)."""
    import dataclasses

    from realtimedepthdiffusion.core import multigrid
    from realtimedepthdiffusion.core.color import rgb_to_gray
    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    rgb = imread_rgb("/root/reference/dataset/images/Dog.jpg")
    mask, value = load_annotation(
        "/root/reference/dataset/annotations/Dog.png"
    )
    h, w = rgb.shape[:2]
    gray0 = rgb_to_gray(jnp.asarray(np.ascontiguousarray(rgb)))
    jm = jnp.asarray(np.ascontiguousarray(mask))
    jv = jnp.asarray(np.ascontiguousarray(value))

    def run(cfg):
        gp = multigrid.build_gray_pyramid(gray0, cfg)
        st0 = multigrid.initial_depth_state(h, w, cfg)
        d, _ = multigrid.solve_cascade(gp, jm, jv, st0, cfg)
        return np.asarray(d)

    cfg1 = DiffusionConfig()
    truth = run(dataclasses.replace(cfg1, max_iterations=8 * cfg1.max_iterations))
    rmse = lambda a: float(np.sqrt(np.mean(((a - truth) / 255.0) ** 2)))
    cfg2 = DiffusionConfig(solver="red_black", early_exit=True,
                           tolerance=1e-3, residual_check_every=25)
    assert rmse(run(cfg2)) <= rmse(run(cfg1))


@pytest.mark.parametrize("metric", ["rms", "max"])
def test_red_black_early_exit(rng, metric):
    """With early exit the selected residual metric at return is below
    tolerance*255 (or the iteration cap was hit) and the result stays close
    to the full run."""
    gray, mask, val, depth = _case(rng, 32, 40)
    cfg = DiffusionConfig(solver="red_black", early_exit=True, tolerance=1e-4,
                          residual_check_every=10, residual_metric=metric)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, cfg)
    u = solver.solve_red_black(
        jnp.asarray(depth), jnp.asarray(mask), jw, 5000, cfg
    )
    res = float(solver.residual_metric_fn(cfg)(u, jnp.asarray(mask), jw))
    assert res < 1e-4 * 255.0
    # Dirichlet pixels still pinned, result in the solver's bounded range.
    got = np.asarray(u)
    assert np.array_equal(got[mask], depth[mask])
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_residual_metric_fn(rng):
    """rms <= max pointwise (Cauchy-Schwarz on the residual field), both
    agree on a converged field, and unknown names are rejected loudly."""
    gray, mask, val, depth = _case(rng, 24, 32)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    u = solver.solve_red_black(jnp.asarray(depth), jnp.asarray(mask), jw, 40,
                               DiffusionConfig(solver="red_black"))
    r_max = float(solver.residual_norm(u, jnp.asarray(mask), jw))
    r_rms = float(solver.residual_rms(u, jnp.asarray(mask), jw))
    assert 0.0 <= r_rms <= r_max
    assert solver.residual_metric_fn(DiffusionConfig()) is solver.residual_rms
    assert (solver.residual_metric_fn(DiffusionConfig(residual_metric="max"))
            is solver.residual_norm)
    with pytest.raises(ValueError, match="residual_metric"):
        solver.residual_metric_fn(DiffusionConfig(residual_metric="l7"))


def test_unknown_solver_and_backend_rejected(rng):
    """C20 error-checking: a typo'd solver or backend name must raise a
    ValueError naming the valid choices, not a bare KeyError (solver) or a
    silent fallthrough (backend), at the first solve_level call."""
    from realtimedepthdiffusion.ops import dispatch

    gray, mask, val, depth = _case(rng, 16, 24)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 4)
    with pytest.raises(ValueError, match="unknown solver"):
        solver.solve_level(*args, DiffusionConfig(solver="jacobi_chebyshv"))
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.solve_level(*args, DiffusionConfig(backend="pallaz"))


def test_subnormal_flush_boundary():
    """The isolated-pixel cut sits exactly at the float32 normal/subnormal
    boundary OF THE INDIVIDUAL WEIGHTS (exp(-beta*sad) < ~1.18e-38, i.e.
    contrast > ~218 at beta=0.4): CUDA's expf and XLA's exp flush subnormal
    outputs (FTZ) while NumPy keeps them, so both implementations pin the
    flush explicitly — a contrast-219 pixel is isolated (each weight ~9e-39
    subnormal), a contrast-217 pixel (weights ~2e-38, normal) takes the
    weighted-mean path with a finite reciprocal. Oracle and JAX must agree
    on both sides."""
    for contrast, expect_isolated in ((219, True), (217, False)):
        gray = np.zeros((5, 5), np.uint8)
        gray[2, 2] = contrast
        jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
        inv = float(jw.inv_count[2, 2])
        ow = oracle.edge_weights(gray, None, 1, 1, CFG)
        oinv = oracle._inv_count(sum(ow))[2, 2]
        if expect_isolated:
            assert inv == 0.0 and oinv == 0.0, contrast
        else:
            assert 0.0 < inv < np.inf and 0.0 < oinv < np.inf, contrast
            np.testing.assert_allclose(inv, oinv, rtol=1e-6)


def test_subnormal_weight_sum_is_isolated():
    """An extreme-contrast isolated pixel produces a subnormal weight sum
    (~4*exp(-0.4*255) ~ 2e-44); 1/count would overflow to inf and poison the
    solve with NaN. The framework flushes it to the isolated-pixel rule
    (result 0, like GPU FTZ hitting the reference's count==0 branch)."""
    gray = np.zeros((5, 5), np.uint8)
    gray[2, 2] = 255  # isolated extreme-contrast pixel
    mask = np.zeros((5, 5), bool)
    depth = np.full((5, 5), 200.0, np.float32)

    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, CFG)
    assert np.isfinite(np.asarray(jw.inv_count)).all()
    assert float(jw.inv_count[2, 2]) == 0.0

    out = np.asarray(
        solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 50, CFG
        )
    )
    assert np.isfinite(out).all()
    want = oracle.solve_level(depth, mask, gray, 1, 1, 50, CFG)
    np.testing.assert_allclose(out, want, atol=5e-2)


def test_every_solver_early_exit_chunked_bitwise(rng):
    """With an UNREACHABLE tolerance the chunked early-exit while_loop is
    BITWISE identical to the fixed-iteration loop for EVERY solver: the
    omega tables are indexed by the global iteration, so the Chebyshev /
    Golub-Varga recurrences continue seamlessly across chunk boundaries
    (the round-4 verdict's omega-continuity requirement), and the truncated
    final chunk (40 = 5x7 + 5 here) lands exactly on the cap."""
    gray, mask, val, depth = _case(rng, 32, 40)
    for sv in ("jacobi_chebyshev", "jacobi", "red_black"):
        cfg = DiffusionConfig(solver=sv)
        cfg_ee = DiffusionConfig(solver=sv, early_exit=True, tolerance=0.0,
                                 residual_check_every=7)
        jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, cfg)
        fn = solver._SOLVERS[sv]
        a = np.asarray(fn(jnp.asarray(depth), jnp.asarray(mask), jw, 40, cfg))
        b = np.asarray(
            fn(jnp.asarray(depth), jnp.asarray(mask), jw, 40, cfg_ee)
        )
        np.testing.assert_array_equal(a, b, err_msg=sv)


@pytest.mark.parametrize("metric", ["rms", "max"])
def test_chebyshev_early_exit_fires(rng, metric):
    """The reference-default solver honors the tolerance (round-4 verdict
    task #2; the reference declares tolerance=1e-5 and ignores it,
    src/main.cpp:264): with a loose tolerance and a huge cap the returned
    residual is below tolerance*255, Dirichlet pixels stay pinned, and the
    iterate differs from the full-cap run (proof the exit actually fired
    rather than running the cap)."""
    gray, mask, val, depth = _case(rng, 32, 40)
    cfg = DiffusionConfig(early_exit=True, tolerance=1e-3,
                          residual_check_every=10, residual_metric=metric)
    jw = weights.edge_weights(jnp.asarray(gray), None, 1, 1, cfg)
    u = solver.solve_jacobi_chebyshev(
        jnp.asarray(depth), jnp.asarray(mask), jw, 3000, cfg
    )
    res = float(solver.residual_metric_fn(cfg)(u, jnp.asarray(mask), jw))
    assert res < 1e-3 * 255.0
    got = np.asarray(u)
    assert np.array_equal(got[mask], depth[mask])
    full = np.asarray(
        solver.solve_jacobi_chebyshev(
            jnp.asarray(depth), jnp.asarray(mask), jw, 3000,
            DiffusionConfig(), early_exit=False,
        )
    )
    assert np.abs(got - full).max() > 0.0  # exited before the cap
