"""Matrix-free diffusion solvers (pure-XLA path).

Redesign of GPUMatrixFreeSolver (src/GPUSolver.cu:274-316):

- The reference launches one CUDA kernel per sweep (~1937 launches per
  solve, SURVEY.md §3.2). Here the whole fixed-iteration loop is a single
  ``lax.fori_loop`` inside one compiled XLA program — zero host
  round-trips. XLA:GPU still launches at least one kernel per sweep, which
  is what the coarse-level kernel (ops/coarse_sweep.py) removes.
- The reference ping-pongs two dense buffers and early-returns at scribbled
  pixels so they keep their seeded value (src/GPUSolver.cu:248,301-312).
  Functionally that is a single carried state ``u`` with
  ``u' = where(mask, u, chebyshev_update)`` — proven equivalent because both
  ping-pong buffers are initialized from the seeded depth and scribbled
  pixels are never written.
- The per-pixel division by the weight sum is hoisted out of the loop as a
  precomputed reciprocal (EdgeWeights.inv_count).

Solvers provided:
- ``jacobi_chebyshev``: the reference algorithm (Wang ToG 2015 schedule,
  src/GPUSolver.cu:295-299), fixed iteration count.
- ``jacobi``: plain damped-free Jacobi (omega == 1 forever).
- ``red_black``: red-black Gauss-Seidel (BASELINE.json config #2).

EVERY solver honors the optional residual-tolerance early exit — the
tolerance parameter the reference accepts but ignores (src/main.cpp:264).
The loop becomes a chunked ``lax.while_loop`` (``residual_check_every``
iterations between residual probes); the chunk bodies index the SAME
per-iteration omega tables as the fixed-iteration path, so with an
unreachable tolerance the chunked loop is bitwise identical to the
fixed-count loop (tests/test_weights_and_solver.py pins this), and the
Chebyshev omega recurrence continues seamlessly across chunk boundaries.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DiffusionConfig
from .weights import EdgeWeights, edge_weights


def chebyshev_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Per-iteration omega schedule (src/GPUSolver.cu:295-299): omega = 1 for
    the first S sweeps, then 2/(2-rho^2), then the recurrence
    4/(4-rho^2*omega). Reproduces the reference's float32 storage with
    float64 update arithmetic. Computed host-side once (it depends only on
    the static iteration count) and baked into the compiled program."""
    s = cfg.chebyshev_s
    # C operator semantics of `4.0 / (4.0 - rho * rho * omega)` with float
    # rho/omega: the product chain evaluates left-to-right entirely in
    # float32; only the subtraction against the double literal promotes.
    rho2 = np.float32(cfg.chebyshev_rho) * np.float32(cfg.chebyshev_rho)
    out = np.empty(max(iters, 1), dtype=np.float32)
    omega = np.float32(0.0)
    for i in range(max(iters, 1)):
        if i < s:
            omega = np.float32(1.0)
        elif i == s:
            omega = np.float32(2.0 / (2.0 - np.float64(rho2)))
        else:
            omega = np.float32(4.0 / (4.0 - np.float64(rho2 * omega)))
        out[i] = omega
    return out[:iters]


def rb_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Per-half-sweep SOR omega schedule for red-black Gauss-Seidel:
    the cyclic Chebyshev semi-iterative method (Golub & Varga 1961) —
    the red-black twin of ``chebyshev_omegas``.

    For a matrix with Property A (the 5-point stencil has it), relaxing the
    colors alternately with

        omega^(1) = 1,  omega^(3/2) = 1/(1 - rho^2/2),
        omega^(tau + 1/2) = 1/(1 - rho^2*omega^(tau)/4)

    converges at the optimal-SOR asymptotic rate (omega -> 2/(1+sqrt(1-rho^2)))
    with none of SOR's slow transient — about TWICE the per-iteration rate of
    the Chebyshev-accelerated Jacobi schedule. rho is ``cfg.rb_rho``
    (0.9999 default — the reference's 0.99 underestimates real image grids,
    which is fatal for Chebyshev methods; see the config docstring), and the
    same S-half-sweep plain warm-up the reference gives Jacobi damps the
    high-frequency transient before extrapolation starts.

    Returns an (iters, 2) float32 table: [:, 0] is the red half-sweep's
    omega, [:, 1] the black half-sweep's. All-ones when ``cfg.rb_chebyshev``
    is off (plain Gauss-Seidel, the round-2 behavior).
    """
    n = max(iters, 1)
    out = np.ones((n, 2), dtype=np.float32)
    if cfg.rb_chebyshev:
        rho2 = float(np.float32(cfg.rb_rho)) ** 2
        s = cfg.chebyshev_s
        omega = 1.0
        for half in range(2 * n):
            if half < s:
                omega = 1.0
            elif half == s:
                omega = 1.0 / (1.0 - rho2 / 2.0)
            else:
                omega = 1.0 / (1.0 - rho2 * omega / 4.0)
            out[half // 2, half % 2] = np.float32(omega)
    return out[:iters]


def _neighbors(u: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shifted views (left/right/up/down neighbor values, zero outside).

    The zero fill never leaks: border weights are exactly 0 there
    (the reference's index-256 sentinel).
    """
    h, w = u.shape
    z_c = jnp.zeros((h, 1), dtype=u.dtype)
    z_r = jnp.zeros((1, w), dtype=u.dtype)
    u_l = jnp.concatenate([z_c, u[:, :-1]], axis=1)
    u_r = jnp.concatenate([u[:, 1:], z_c], axis=1)
    u_u = jnp.concatenate([z_r, u[:-1, :]], axis=0)
    u_d = jnp.concatenate([u[1:, :], z_r], axis=0)
    return u_l, u_r, u_u, u_d


def jacobi_sweep(u: jnp.ndarray, wts: EdgeWeights) -> jnp.ndarray:
    """One weighted 5-point relaxation (solveDiffusion,
    src/GPUSolver.cu:73-106): clip(sum(w_i * u_i) * inv_count, 0, 255); the
    all-weights-absent case yields 0 via inv_count == 0."""
    u_l, u_r, u_u, u_d = _neighbors(u)
    s = wts.wl * u_l + wts.wr * u_r + wts.wu * u_u + wts.wd * u_d
    return jnp.clip(s * wts.inv_count, 0.0, 255.0)


def jacobi_sweep_raw(u: jnp.ndarray, wts: EdgeWeights) -> jnp.ndarray:
    """Unclamped weighted average — the linear operator M = D^{-1}W.

    Used by the V-cycle error equations (core/multigrid.py), which require a
    *linear* smoother; the reference's clamp (src/GPUSolver.cu:104) is only
    applied on the primal variable path.
    """
    u_l, u_r, u_u, u_d = _neighbors(u)
    s = wts.wl * u_l + wts.wr * u_r + wts.wu * u_u + wts.wd * u_d
    return s * wts.inv_count


def residual_norm(u: jnp.ndarray, mask: jnp.ndarray, wts: EdgeWeights) -> jnp.ndarray:
    """Max-norm residual |relax(u) - u| over non-scribble pixels — the
    convergence probe the reference lacks (its deviceError buffer is dead,
    SURVEY.md quirk #2)."""
    r = jacobi_sweep(u, wts) - u
    return jnp.max(jnp.abs(jnp.where(mask, 0.0, r)))


def residual_rms(u: jnp.ndarray, mask: jnp.ndarray, wts: EdgeWeights) -> jnp.ndarray:
    """RMS residual sqrt(mean |relax(u) - u|^2) over non-scribble pixels.

    The early-exit metric that remains meaningful at fine cascade levels:
    the max-norm is pinned by a few stubborn weak-edge pixels that do not
    converge within the level's iteration budget at all (Flower L0 ends at
    max 31.9 gray levels after the FULL cap while the RMS is 0.11), so a
    max-norm exit never fires exactly where the time is spent."""
    r = jnp.where(mask, 0.0, jacobi_sweep(u, wts) - u)
    cnt = jnp.maximum(jnp.sum(jnp.where(mask, 0.0, 1.0)), 1.0)
    return jnp.sqrt(jnp.sum(r * r) / cnt)


def residual_metric_fn(cfg: DiffusionConfig):
    """The residual functional selected by ``cfg.residual_metric``."""
    try:
        return {"max": residual_norm, "rms": residual_rms}[cfg.residual_metric]
    except KeyError:
        raise ValueError(
            f"unknown residual_metric {cfg.residual_metric!r}; "
            "expected 'rms' or 'max'"
        ) from None


def _chunked_early_exit(body, carry0, extract_u, mask, wts, iters, cfg):
    """Run ``body(i, carry)`` (one iteration of any solver) inside a chunked
    ``lax.while_loop`` that stops once the residual of ``extract_u(carry)``
    drops below tolerance*255 (probed every ``cfg.residual_check_every``
    iterations; metric per ``cfg.residual_metric``). The final chunk is
    truncated so the iteration cap is never exceeded — the iteration indices
    visited are exactly 0..n for some n <= iters, so with an unreachable
    tolerance the result is bitwise identical to ``fori_loop(0, iters,
    body, carry0)``. Shared by all three solvers (the omega recurrence of
    each lives in its per-iteration table, indexed by the global iteration
    ``i``, so schedules continue seamlessly across chunk boundaries)."""
    tol = jnp.float32(cfg.tolerance) * jnp.float32(255.0)
    chunk = max(int(cfg.residual_check_every), 1)
    res_fn = residual_metric_fn(cfg)

    def cond(state):
        carry, i, res = state
        return (i < iters) & (res >= tol)

    def step(state):
        carry, i, _ = state
        n = jnp.minimum(jnp.int32(chunk), jnp.int32(iters) - i)
        carry = jax.lax.fori_loop(i, i + n, body, carry)
        return carry, i + n, res_fn(extract_u(carry), mask, wts)

    carry, _, _ = jax.lax.while_loop(
        cond, step, (carry0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    return carry


def solve_jacobi_chebyshev(
    depth: jnp.ndarray,
    mask: jnp.ndarray,
    wts: EdgeWeights,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
    early_exit: bool | None = None,
) -> jnp.ndarray:
    """Jacobi + Chebyshev semi-iteration at one level (the reference
    algorithm), fixed-iteration by default with optional residual early
    exit (the reference declares tolerance=1e-5 and ignores it,
    src/main.cpp:264; here it is honored when ``early_exit``).

    ``depth`` must be pre-seeded. The Chebyshev history starts at zero
    (cudaMemset, src/GPUSolver.cu:290); the extrapolated update
    omega*(gamma*(r-u) + u - prev) + prev is NOT clamped (only the inner
    average is), matching src/GPUSolver.cu:259. Early exit carries
    (u, prev) through the chunked while_loop with omegas indexed by the
    global iteration, so the Wang schedule continues across chunks.
    """
    if iters <= 0:
        return depth.astype(jnp.float32)
    if early_exit is None:
        early_exit = cfg.early_exit
    omegas = jnp.asarray(chebyshev_omegas(iters, cfg))
    gamma = jnp.float32(cfg.chebyshev_gamma)
    u0 = depth.astype(jnp.float32)
    prev0 = jnp.zeros_like(u0)

    def body(i, state):
        u, prev = state
        omega = omegas[i]
        r = jacobi_sweep(u, wts)
        out = omega * (gamma * (r - u) + u - prev) + prev
        return jnp.where(mask, u, out), u

    if early_exit:
        u, _ = _chunked_early_exit(
            body, (u0, prev0), lambda c: c[0], mask, wts, iters, cfg
        )
        return u
    u, _ = jax.lax.fori_loop(0, iters, body, (u0, prev0))
    return u


def solve_jacobi(
    depth: jnp.ndarray,
    mask: jnp.ndarray,
    wts: EdgeWeights,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
    early_exit: bool | None = None,
) -> jnp.ndarray:
    """Plain Jacobi (no Chebyshev acceleration): the BASELINE.json config #1
    solver and the simplest correctness anchor. Honors the residual early
    exit like every other solver."""
    u0 = depth.astype(jnp.float32)
    if early_exit is None:
        early_exit = cfg.early_exit

    def body(i, u):
        return jnp.where(mask, u, jacobi_sweep(u, wts))

    if early_exit:
        return _chunked_early_exit(
            body, u0, lambda c: c, mask, wts, iters, cfg
        )
    return jax.lax.fori_loop(0, iters, body, u0)


def red_black_parity(h: int, w: int) -> jnp.ndarray:
    """Checkerboard mask: True at red cells ((y+x) even)."""
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return ((yy + xx) % 2) == 0


def red_black_iter(u: jnp.ndarray, mask: jnp.ndarray, wts: EdgeWeights,
                   red: jnp.ndarray, om_r=1.0, om_b=1.0) -> jnp.ndarray:
    """One red-black iteration: red cells take the clipped weighted average
    of the current state over-relaxed by ``om_r`` — PROJECTED SOR,
    clip(u + omega*(avg - u), 0, 255), which reduces exactly to plain
    Gauss-Seidel at omega == 1 and keeps the iterate inside the solver's
    [0, 255] range (unlike the Jacobi+Chebyshev path's unclamped
    extrapolation, the RB solver is our extension and gets the tighter
    invariant) — then black cells of the half-updated state with ``om_b``."""
    upd = jacobi_sweep(u, wts)
    u = jnp.where(red & ~mask, jnp.clip(u + om_r * (upd - u), 0.0, 255.0), u)
    upd = jacobi_sweep(u, wts)
    return jnp.where(
        ~red & ~mask, jnp.clip(u + om_b * (upd - u), 0.0, 255.0), u
    )


def solve_red_black(
    depth: jnp.ndarray,
    mask: jnp.ndarray,
    wts: EdgeWeights,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
    early_exit: bool | None = None,
) -> jnp.ndarray:
    """Red-black Gauss-Seidel with optional residual early exit
    (BASELINE.json config #2).

    Each iteration updates red cells ((y+x) even) from the current state,
    then black cells from the half-updated state, each half-sweep
    over-relaxed by the cyclic-Chebyshev omega schedule (``rb_omegas``;
    plain Gauss-Seidel when ``cfg.rb_chebyshev`` is off). When
    ``early_exit`` the loop is a ``lax.while_loop`` that stops once the
    residual (``cfg.residual_metric``: rms default, or max-norm) drops below
    tolerance*255 (checked every ``cfg.residual_check_every`` iterations).
    """
    h, w = depth.shape
    red = red_black_parity(h, w)
    u0 = depth.astype(jnp.float32)
    if early_exit is None:
        early_exit = cfg.early_exit
    if iters <= 0:
        return u0
    om = jnp.asarray(rb_omegas(iters, cfg))

    def one_iter(i, u):
        return red_black_iter(u, mask, wts, red, om[i, 0], om[i, 1])

    if not early_exit:
        return jax.lax.fori_loop(0, iters, one_iter, u0)
    return _chunked_early_exit(
        one_iter, u0, lambda c: c, mask, wts, iters, cfg
    )


_SOLVERS = {
    "jacobi_chebyshev": solve_jacobi_chebyshev,
    "jacobi": solve_jacobi,
    "red_black": solve_red_black,
}


def solve_level(
    depth: jnp.ndarray,
    mask: jnp.ndarray,
    gray: jnp.ndarray,
    level: int,
    max_level: int,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> jnp.ndarray:
    """Weights + sweeps for one pyramid level (the body of
    GPUMatrixFreeSolver). Weight planes are computed from the *incoming*
    depth state (the pyrUp'd, re-seeded map), exactly like loadIndexToWeight
    running before the sweep loop (src/GPUSolver.cu:293)."""
    wts = edge_weights(gray, depth, level, max_level, cfg)
    solver = _SOLVERS.get(cfg.solver)
    if solver is None:
        raise ValueError(
            f"unknown solver {cfg.solver!r}; expected one of {sorted(_SOLVERS)}"
        )
    return solver(depth, mask, wts, iters, cfg)
