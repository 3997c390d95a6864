"""Multi-chip path on the 8-device virtual CPU mesh (SURVEY.md §4): halo
exchange correctness, sharded-vs-single-chip parity, batched step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import multigrid, solver
from realtimedepthdiffusion.oracle import numpy_ref as oracle
from realtimedepthdiffusion.parallel import sharded
from realtimedepthdiffusion.parallel.halo import crop_halo, extend_with_halo
from realtimedepthdiffusion.parallel.mesh import factor3, make_mesh
from tests.conftest import synthetic_pair

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_factor3():
    assert factor3(8) == (2, 2, 2)
    assert factor3(4) == (1, 2, 2)
    assert factor3(2) == (1, 1, 2)
    assert factor3(1) == (1, 1, 1)
    assert factor3(6) == (1, 2, 3)


def test_make_mesh_raises_when_too_few_devices(monkeypatch):
    """make_mesh never moves to another platform: fewer devices than asked
    for on the default platform (or in ``devices``) is an error."""
    from realtimedepthdiffusion.parallel import mesh as mesh_mod

    real_devices = jax.devices
    monkeypatch.setattr(
        mesh_mod.jax, "devices", lambda backend=None: real_devices()[:1]
    )
    with pytest.raises(ValueError, match="only 1 available on platform 'cpu'"):
        mesh_mod.make_mesh(8)
    with pytest.raises(ValueError, match="only"):
        mesh_mod.make_mesh(8, devices=real_devices()[:1])
    assert mesh_mod.make_mesh(1).devices.size == 1


def test_halo_exchange_reassembles_global():
    """extend_with_halo must deliver the true global neighborhood: cropping
    an extended identity map equals a plain global pad-and-slice."""
    mesh = make_mesh(8)
    h, w = 32, 64
    x = jnp.arange(h * w, dtype=jnp.float32).reshape(h, w)
    k = 4

    # Invariant 1: the extended block's interior equals the block.
    def local2(xb):
        e = extend_with_halo(xb, k)
        return e[k:-k, k:-k]

    f = jax.shard_map(
        local2, mesh=mesh, in_specs=jax.sharding.PartitionSpec("dy", "dx"),
        out_specs=jax.sharding.PartitionSpec("dy", "dx"),
    )
    np.testing.assert_array_equal(np.asarray(f(x)), np.asarray(x))

    # And a halo-based global shift equals jnp.roll-with-zeros.
    def shift_up(xb):
        e = extend_with_halo(xb, 1)
        return e[2:, 1:-1]  # row y takes value from y+1 (zero at bottom)

    g = jax.shard_map(
        shift_up, mesh=mesh, in_specs=jax.sharding.PartitionSpec("dy", "dx"),
        out_specs=jax.sharding.PartitionSpec("dy", "dx"),
    )
    want = np.zeros((h, w), np.float32)
    want[:-1] = np.asarray(x)[1:]
    np.testing.assert_array_equal(np.asarray(g(x)), want)


@pytest.mark.slow
def test_sharded_level_matches_single_chip(rng):
    mesh = make_mesh(8)
    cfg = DiffusionConfig()
    h, w = 65, 97  # non-divisible by the mesh: exercises padding
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)

    got = np.asarray(
        sharded.solve_level_sharded(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 21,
            mesh, cfg, halo=4,
        )
    )
    want = np.asarray(
        solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 21, cfg
        )
    )
    assert np.sqrt(np.mean(((got - want) / 255.0) ** 2)) < 1e-4
    assert np.array_equal(got[mask], depth[mask])


@pytest.mark.slow
def test_sharded_cascade_parity():
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=24)
    rgb, m0, v0 = synthetic_pair(64, 96, 3)
    g0 = oracle.rgb_to_gray(rgb)
    gp = multigrid.build_gray_pyramid(jnp.asarray(g0), cfg)

    st = multigrid.initial_depth_state(64, 96, cfg)
    d_s, _ = sharded.solve_cascade_sharded(
        gp, jnp.asarray(m0), jnp.asarray(v0), st, mesh, cfg, halo=4
    )
    st = multigrid.initial_depth_state(64, 96, cfg)
    d_1, _ = multigrid.solve_cascade(gp, jnp.asarray(m0), jnp.asarray(v0), st, cfg)
    rmse = float(jnp.sqrt(jnp.mean(((d_s - d_1) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse


@pytest.mark.slow
def test_batched_step_runs_and_pins_scribbles():
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=16)
    fn, make_args = sharded.batched_step(mesh, 64, 64, cfg)
    args = make_args(2)
    depth, state, out = fn(*args)
    assert depth.shape == (2, 64, 64)
    assert out.shape == (2, 64, 64, 3) and out.dtype == jnp.uint8
    d = np.asarray(depth)
    assert d[0, 16, 16] == 254.0  # the painted near scribble is pinned
    assert len(state) == cfg.num_levels(64, 64)


@pytest.mark.slow
def test_sharded_red_black_matches_single_chip(rng):
    """Sharded red-black (2k-halo color-masked blocks) == core red-black."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(solver="red_black")
    h, w = 65, 97
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)

    got = np.asarray(
        sharded.solve_level_sharded(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 13,
            mesh, cfg, halo=4,
        )
    )
    want = np.asarray(
        solver.solve_level(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1, 13, cfg
        )
    )
    assert np.sqrt(np.mean(((got - want) / 255.0) ** 2)) < 1e-4
    assert np.array_equal(got[mask], depth[mask])


@pytest.mark.slow
def test_sharded_red_black_early_exit_matches_single_chip(rng):
    """Config #2 multi-chip: pmax'd global residual early exit stops the
    sharded solve at the same iterate as the single-chip while_loop,
    including the truncated final chunk."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(solver="red_black", early_exit=True,
                          residual_check_every=6, tolerance=1e-4)
    h, w = 64, 96
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray))

    got = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg, halo=4)
    )
    want = np.asarray(solver.solve_level(*args, 1, 1, 20, cfg))
    assert np.sqrt(np.mean(((got - want) / 255.0) ** 2)) < 1e-4


@pytest.mark.slow
def test_sharded_red_black_early_exit_runs_truncated_tail(rng):
    """When the tolerance can never fire, early-exit red-black must complete
    EXACTLY the iteration cap — including the final chunk that
    residual_check_every does not divide (20 = 3x6 + 2 here). The shard_map'd
    while loop only runs full chunks; the GSPMD tail in solve_level_sharded
    owns the remainder. Guarded tightly: the early-exit iterate must match
    the fixed-count sharded solve (same rb_omegas indices, same halo
    blocking), which an 18-vs-20-iteration shortfall visibly breaks."""
    mesh = make_mesh(8)
    cfg_ee = DiffusionConfig(solver="red_black", early_exit=True,
                             residual_check_every=6, tolerance=1e-12)
    cfg_fx = DiffusionConfig(solver="red_black")
    h, w = 64, 96
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray))

    got = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg_ee, halo=4)
    )
    want = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg_fx, halo=4)
    )
    # Sanity: 18 iterations are measurably different from 20 on this problem.
    short = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 18, mesh, cfg_fx, halo=4)
    )
    gap = np.sqrt(np.mean(((short - want) / 255.0) ** 2))
    assert gap > 1e-6, f"18-vs-20 gap {gap} too small to guard the tail"
    err = np.sqrt(np.mean(((got - want) / 255.0) ** 2))
    assert err < gap / 10, (err, gap)

    # The observability probe must NOT claim the exit fired: the while
    # loop stopped at 18 (the last full chunk) but the tail ran the
    # remaining 2, so the full budget ran and iters_done must say 20.
    # (Pre-fix this returned 18 — a caller using the documented
    # "iters_done < iters <=> exit fired" probe was lied to whenever
    # residual_check_every did not divide the budget.)
    _, done, res = sharded.solve_level_sharded(
        *args, 1, 1, 20, mesh, cfg_ee, halo=4, return_info=True
    )
    assert int(done) == 20, int(done)
    assert float(res) >= cfg_ee.tolerance * 255.0


@pytest.mark.slow
def test_sharded_cascade_red_black_parity():
    """solve_cascade_sharded with solver='red_black' (config #2 end-to-end,
    the round-1 NotImplementedError lifted)."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=24, solver="red_black",
                          early_exit=True, residual_check_every=8)
    rgb, m0, v0 = synthetic_pair(64, 96, 3)
    g0 = oracle.rgb_to_gray(rgb)
    gp = multigrid.build_gray_pyramid(jnp.asarray(g0), cfg)

    st = multigrid.initial_depth_state(64, 96, cfg)
    d_s, _ = sharded.solve_cascade_sharded(
        gp, jnp.asarray(m0), jnp.asarray(v0), st, mesh, cfg, halo=4
    )
    st = multigrid.initial_depth_state(64, 96, cfg)
    d_1, _ = multigrid.solve_cascade(gp, jnp.asarray(m0), jnp.asarray(v0), st, cfg)
    rmse = float(jnp.sqrt(jnp.mean(((d_s - d_1) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse


@pytest.mark.slow
def test_sharded_vcycle_parity():
    """Multi-chip V-cycle (config #4): sharded warm cascade + GSPMD-global
    polish matches the single-chip solve_vcycle."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=24, multigrid="vcycle",
                          vcycle_coarse_iters=40, vcycles=1)
    rgb, m0, v0 = synthetic_pair(64, 96, 3)
    g0 = oracle.rgb_to_gray(rgb)
    gp = multigrid.build_gray_pyramid(jnp.asarray(g0), cfg)

    st = multigrid.initial_depth_state(64, 96, cfg)
    d_s, _ = sharded.solve_vcycle_sharded(
        gp, jnp.asarray(m0), jnp.asarray(v0), st, mesh, cfg, halo=4
    )
    st = multigrid.initial_depth_state(64, 96, cfg)
    d_1, _ = multigrid.solve_vcycle(gp, jnp.asarray(m0), jnp.asarray(v0), st, cfg)
    rmse = float(jnp.sqrt(jnp.mean(((d_s - d_1) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse


@pytest.mark.slow
def test_batched_step_vcycle_runs():
    """batched_step routes multigrid='vcycle' through solve_vcycle_sharded
    (the round-1 NotImplementedError for config #4 lifted)."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=16, multigrid="vcycle", vcycles=1,
                          vcycle_coarse_iters=20)
    fn, make_args = sharded.batched_step(mesh, 64, 64, cfg)
    depth, state, out = fn(*make_args(2))
    assert depth.shape == (2, 64, 64)
    d = np.asarray(depth)
    assert d[0, 16, 16] == 254.0  # scribble pinned through the cycles


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
@pytest.mark.parametrize("entry", ["solve_level_sharded", "batched_step"])
def test_sharded_path_rejects_kernel_backends(entry, backend):
    """The sharded solve has no kernel on any platform: asking for one
    raises instead of silently running the jnp blocks."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=12, backend=backend)
    with pytest.raises(ValueError, match="kernel"):
        if entry == "batched_step":
            sharded.batched_step(mesh, 64, 64, cfg)
        else:
            z = jnp.zeros((64, 96), jnp.float32)
            sharded.solve_level_sharded(
                z, z > 0, z.astype(jnp.uint8), 1, 1, 8, mesh, cfg, halo=4
            )


def test_batched_step_defocus_effect():
    """batched_step renders defocus as the vmapped XLA formulation,
    partitioned over the mesh; it equals the same formulation under jit."""
    from realtimedepthdiffusion.core import effects as fx

    mesh = make_mesh(8)
    cfg = DiffusionConfig(max_iterations=12)
    fn, make_args = sharded.batched_step(mesh, 48, 64, cfg, effect=fx.EFFECT_DEFOCUS)
    rgb, mask, value, state = make_args(2)
    depth, _, out = fn(rgb, mask, value, state)
    assert out.shape == (2, 48, 64, 3) and out.dtype == jnp.uint8
    # The expectation is computed under jit like the step itself: the window
    # half-width k*d/255 sits on an f32 knife edge for solve outputs like
    # 254.99998, and either FMA contraction is faithful.
    want = np.asarray(
        jax.jit(
            jax.vmap(lambda r, d: fx.defocus(r, jnp.clip(d, 0.0, 255.0), cfg))
        )(rgb, depth)
    )
    np.testing.assert_array_equal(np.asarray(out), want)


@pytest.mark.slow
def test_sharded_chebyshev_early_exit_matches_single_chip(rng):
    """The reference-default solver honors the tolerance on the MULTI-CHIP
    path too (round-4 verdict task #2): the pmax/psum'd global residual
    stops the sharded jacobi_chebyshev at the same iterate as the
    single-chip chunked while_loop, (u, prev) carried across chunks with
    the omega schedule dynamic-sliced by global iteration."""
    mesh = make_mesh(8)
    cfg = DiffusionConfig(early_exit=True, residual_check_every=6,
                          tolerance=1e-4)
    h, w = 64, 96
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray))

    got = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg, halo=4)
    )
    want = np.asarray(solver.solve_level(*args, 1, 1, 20, cfg))
    assert np.sqrt(np.mean(((got - want) / 255.0) ** 2)) < 1e-4
    assert np.array_equal(got[mask], depth[mask])


@pytest.mark.slow
def test_sharded_chebyshev_early_exit_runs_truncated_tail(rng):
    """Unreachable tolerance: the sharded early-exit chebyshev completes
    EXACTLY the iteration cap — the while_loop runs full chunks only and
    the GSPMD tail (carrying u AND the Chebyshev prev) owns the remainder
    (20 = 3x6 + 2 here), with the observability probe reporting the full
    budget ran (iters_done == 20, not 18)."""
    mesh = make_mesh(8)
    cfg_ee = DiffusionConfig(early_exit=True, residual_check_every=6,
                             tolerance=1e-12)
    cfg_fx = DiffusionConfig()
    h, w = 64, 96
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) < 0.06
    val = rng.integers(0, 255, (h, w), dtype=np.uint8)
    depth = oracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, val)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray))

    got = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg_ee, halo=4)
    )
    want = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 20, mesh, cfg_fx, halo=4)
    )
    short = np.asarray(
        sharded.solve_level_sharded(*args, 1, 1, 18, mesh, cfg_fx, halo=4)
    )
    gap = np.sqrt(np.mean(((short - want) / 255.0) ** 2))
    assert gap > 1e-6, f"18-vs-20 gap {gap} too small to guard the tail"
    err = np.sqrt(np.mean(((got - want) / 255.0) ** 2))
    assert err < gap / 10, (err, gap)

    _, done, res = sharded.solve_level_sharded(
        *args, 1, 1, 20, mesh, cfg_ee, halo=4, return_info=True
    )
    assert int(done) == 20, int(done)
    assert float(res) >= cfg_ee.tolerance * 255.0
