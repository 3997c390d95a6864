"""Multi-device spatially-sharded solve (shard_map over a ('batch','dy','dx')
mesh).

Scale-out design (SURVEY.md §5 "long-context" analog): each image is
partitioned into a dy x dx grid of per-device blocks; every k sweeps the
devices exchange a k-wide halo (parallel/halo.py, ppermute) and run k
purely-local sweeps — iteration blocking that amortizes the exchange
latency over k sweeps. Coarse pyramid levels whose blocks would be thinner
than the halo run replicated (they are tiny); fine levels run sharded. The
'batch' axis is plain data parallelism over independent images (the
framework's serving axis; the reference is strictly single-image): the
batched step shard_maps over ALL THREE axes with the local batch riding
along as a leading axis.

The in-shard sweep blocks are jnp; ``ops.dispatch.route(..., 'sharded',
...)`` has no kernel for them on any platform.

Solvers: the reference algorithm (jacobi_chebyshev) and red-black
Gauss-Seidel with a pmax'd global residual early exit (BASELINE config #2).
Numerics are identical to core.solver (same sweep, schedule, masking), so
single-device and sharded solves agree to fp rounding.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DiffusionConfig
from ..core import effects as fx
from ..core.annotation import annotation_pyr_down, seed_depth
from ..core.pyramid import pyr_up
from ..core.weights import edge_weights
from .halo import crop_halo, extend_with_halo

# Halo width == sweeps between exchanges.
DEFAULT_HALO = 8

_SHARDED_SOLVERS = ("jacobi_chebyshev", "red_black")


def _pad_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _check_route(cfg: DiffusionConfig) -> None:
    """The sharded solve has no kernel: ``route`` returns 'xla' for
    'auto'/'xla' and raises for 'pallas'/'pallas_interpret'."""
    from ..ops.dispatch import route

    route(jax.default_backend(), "sharded", cfg.solver, cfg.backend)


def _residual_reduce(d, m, cfg: DiffusionConfig, batched: bool):
    """Globally-agreed residual from the per-pixel |relax(u) - u| plane
    ``d``: every chip sees the same value, so all agree on the stopping
    iteration. max: off-mask max, pmax'd over the spatial axes. rms:
    per-image sum-of-squares and off-mask counts psum'd over the spatial
    axes; the gate is the max over images (exit only when EVERY image in
    the batch has converged), pmax'd over the batch axis."""
    if cfg.residual_metric == "max":
        res = jnp.max(jnp.where(m, 0.0, d))
        res = lax.pmax(lax.pmax(res, "dy"), "dx")
        if batched:
            res = lax.pmax(res, "batch")
        return res
    sq = jnp.sum(jnp.where(m, 0.0, d * d), axis=(-2, -1))
    cnt = jnp.sum(jnp.where(m, 0.0, 1.0), axis=(-2, -1))
    sq = lax.psum(lax.psum(sq, "dy"), "dx")
    cnt = lax.psum(lax.psum(cnt, "dy"), "dx")
    res = jnp.max(jnp.sqrt(sq / jnp.maximum(cnt, 1.0)))
    if batched:
        res = lax.pmax(res, "batch")
    return res


def _sharded_level_fn(mesh: Mesh, k: int, iters: int, cfg: DiffusionConfig,
                      batched: bool = False):
    """Build the shard_map'd Jacobi+Chebyshev solver for one level geometry,
    with the optional residual early exit made global by a pmax/psum over
    the mesh axes exactly like the red-black twin (every chip agrees on the
    stopping iteration; the omega schedule is dynamic-sliced by the global
    iteration so the Wang recurrence continues across chunks).

    Expects globally padded (..., H, W) arrays whose spatial dims divide
    (dy,dx); pad pixels must be masked (Dirichlet 0) and carry zero weights.
    Each k-sweep block between halo exchanges is a jnp roll-based loop with
    core.solver's sweep and Chebyshev update term for term, so sharded and
    single-device solves differ only in how XLA fuses them; the blocks run
    in a fori_loop.

    Returns (u, prev, iters_done, residual); when early exit is off,
    iters_done == iters and residual is +inf.
    """
    from ..core.solver import chebyshev_omegas, residual_metric_fn

    residual_metric_fn(cfg)  # validate the metric name at build time

    chunk = max(int(cfg.residual_check_every), 1)
    tol = np.float32(cfg.tolerance) * np.float32(255.0)
    # Omegas indexed by GLOBAL iteration: the Wang recurrence continues
    # across blocks and early-exit chunks.
    om_full = jnp.asarray(chebyshev_omegas(max(iters, 1), cfg))
    gamma = jnp.float32(cfg.chebyshev_gamma)

    def jnp_block(u_e, p_e, bh_e, bv_e, inv_e, m_e, om):
        """om.shape[0] sweeps on the extended block (roll wraparound only
        corrupts the block edge ring, absorbed by the k-wide halo)."""
        wl_e = jnp.roll(bh_e, 1, -1)
        wu_e = jnp.roll(bv_e, 1, -2)
        for j in range(om.shape[0]):
            r = jnp.clip(
                (
                    wl_e * jnp.roll(u_e, 1, -1)
                    + bh_e * jnp.roll(u_e, -1, -1)
                    + wu_e * jnp.roll(u_e, 1, -2)
                    + bv_e * jnp.roll(u_e, -1, -2)
                )
                * inv_e,
                0.0,
                255.0,
            )
            out = om[j] * (gamma * (r - u_e) + u_e - p_e) + p_e
            u_e, p_e = jnp.where(m_e, u_e, out), u_e
        return u_e, p_e

    def local(u, prev, bh, bv, inv, m):
        # One-time k-halo extension of the loop invariants.
        ext = lambda a: extend_with_halo(a, k)
        bh_e, bv_e, inv_e = ext(bh), ext(bv), ext(inv)
        m_e = ext(m)

        def sweeps(u_c, p_c, om):
            """One halo exchange, then om.shape[0] <= k local sweeps on the
            extended block (validity shrinks one ring per sweep; the interior
            crop is exact)."""
            u_e, p_e = jnp_block(ext(u_c), ext(p_c), bh_e, bv_e, inv_e, m_e, om)
            return crop_halo(u_e, k), crop_halo(p_e, k)

        def run_chunk(u_c, p_c, n_iters, i0):
            """n_iters (static) sweeps in k-blocks starting at GLOBAL
            iteration ``i0`` (traced)."""
            nf, rem_i = divmod(n_iters, k)

            def block(j, c):
                return sweeps(*c, lax.dynamic_slice(om_full, (i0 + j * k,), (k,)))

            u_c, p_c = lax.fori_loop(0, nf, block, (u_c, p_c))
            if rem_i:
                om = lax.dynamic_slice(om_full, (i0 + nf * k,), (rem_i,))
                u_c, p_c = sweeps(u_c, p_c, om)
            return u_c, p_c

        if not cfg.early_exit:
            u, prev = run_chunk(u, prev, iters, jnp.int32(0))
            return u, prev, jnp.int32(iters), jnp.float32(jnp.inf)

        # 1-ring-extended invariants for the residual probe.
        c1 = lambda a: (
            a[..., k - 1 : a.shape[-2] - (k - 1), k - 1 : a.shape[-1] - (k - 1)]
            if k > 1 else a
        )
        bh_1, bv_1, inv_1 = c1(bh_e), c1(bv_e), c1(inv_e)
        wl_1 = jnp.roll(bh_1, 1, -1)
        wu_1 = jnp.roll(bv_1, 1, -2)

        def local_residual(u_c):
            u_1 = extend_with_halo(u_c, 1)
            r = jnp.clip(
                (
                    wl_1 * jnp.roll(u_1, 1, -1)
                    + bh_1 * jnp.roll(u_1, -1, -1)
                    + wu_1 * jnp.roll(u_1, 1, -2)
                    + bv_1 * jnp.roll(u_1, -1, -2)
                )
                * inv_1,
                0.0,
                255.0,
            )
            d = jnp.abs(crop_halo(r, 1) - u_c)
            return _residual_reduce(d, m, cfg, batched)

        def cond(state):
            u_c, p_c, i, res = state
            return (i + chunk <= iters) & (res >= tol)

        def body(state):
            u_c, p_c, i, _ = state
            u_c, p_c = run_chunk(u_c, p_c, chunk, i)
            return u_c, p_c, i + chunk, local_residual(u_c)

        return lax.while_loop(
            cond, body, (u, prev, jnp.int32(0), jnp.float32(jnp.inf))
        )

    spec = P("batch", "dy", "dx") if batched else P("dy", "dx")
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec,) * 6,
        out_specs=(spec, spec, P(), P()),
        check_vma=False,
    )


def _sharded_level_rb_fn(mesh: Mesh, k: int, iters: int, cfg: DiffusionConfig,
                         batched: bool = False):
    """Build the shard_map'd red-black Gauss-Seidel solver for one level
    geometry, with the optional residual early exit made global by a
    pmax/psum over the spatial mesh axes: every chip sees the same residual
    (``cfg.residual_metric``: rms default or max-norm), so all agree on the
    stopping iteration (BASELINE config #2, multi-chip).

    One red-black iteration advances the dependency cone two rings (black
    reads red-updated neighbors), so blocks exchange a 2k-wide halo per k
    iterations. Returns (u, iters_done, residual); when early exit is off,
    iters_done == iters and residual is +inf.
    """
    from ..core.solver import rb_omegas, residual_metric_fn

    residual_metric_fn(cfg)  # validate the metric name at build time

    ew = 2 * k  # halo width per k-iteration block
    tol = np.float32(cfg.tolerance) * np.float32(255.0)
    chunk = max(int(cfg.residual_check_every), 1)
    # Cyclic-Chebyshev SOR omegas, indexed by GLOBAL iteration (the
    # recurrence continues across early-exit chunks).
    om_full = jnp.asarray(rb_omegas(max(iters, 1), cfg))

    def jnp_rb_block(u_e, bh_e, bv_e, inv_e, m_e, red_e, om):
        wl_e = jnp.roll(bh_e, 1, -1)
        wu_e = jnp.roll(bv_e, 1, -2)

        def half(u, sel, omega):
            r = jnp.clip(
                (
                    wl_e * jnp.roll(u, 1, -1)
                    + bh_e * jnp.roll(u, -1, -1)
                    + wu_e * jnp.roll(u, 1, -2)
                    + bv_e * jnp.roll(u, -1, -2)
                )
                * inv_e,
                0.0,
                255.0,
            )
            return jnp.where(
                sel & ~m_e, jnp.clip(u + omega * (r - u), 0.0, 255.0), u
            )

        for j in range(om.shape[0]):
            u_e = half(u_e, red_e, om[j, 0])
            u_e = half(u_e, ~red_e, om[j, 1])
        return u_e

    def local(u, bh, bv, inv, m):
        sp = u.shape[-2:]
        # Global origin of this block (in padded-global coords) for the red
        # checkerboard parity: red == ((y + x) % 2 == 0) globally.
        oy = lax.axis_index("dy") * sp[0]
        ox = lax.axis_index("dx") * sp[1]
        eshape = (sp[0] + 2 * ew, sp[1] + 2 * ew)
        yy = lax.broadcasted_iota(jnp.int32, eshape, 0)
        xx = lax.broadcasted_iota(jnp.int32, eshape, 1)
        red_e2 = ((yy + xx + oy + ox - 2 * ew) % 2) == 0
        if u.ndim == 3:
            red_e2 = jnp.broadcast_to(red_e2, (u.shape[0],) + eshape)

        ext = lambda a: extend_with_halo(a, ew)
        bh_e, bv_e, inv_e, m_e = ext(bh), ext(bv), ext(inv), ext(m)
        # 1-ring-extended invariants for the residual probe.
        c1 = lambda a: a[..., ew - 1 : -(ew - 1), ew - 1 : -(ew - 1)]
        bh_1, bv_1, inv_1 = c1(bh_e), c1(bv_e), c1(inv_e)
        wl_1 = jnp.roll(bh_1, 1, -1)
        wu_1 = jnp.roll(bv_1, 1, -2)

        def rb_iters(u_c, n, i0):
            """One 2k-halo exchange + n <= k local red-black iterations
            starting at global iteration ``i0`` (traced)."""
            om = lax.dynamic_slice(om_full, (i0, jnp.int32(0)), (n, 2))
            u_e = jnp_rb_block(ext(u_c), bh_e, bv_e, inv_e, m_e, red_e2, om)
            return crop_halo(u_e, ew)

        def run_chunk(u_c, n_iters, i0):
            n_full, rem_i = divmod(n_iters, k)
            u_c = lax.fori_loop(
                0, n_full, lambda j, c: rb_iters(c, k, i0 + j * k), u_c
            )
            if rem_i:
                u_c = rb_iters(u_c, rem_i, i0 + n_full * k)
            return u_c

        def local_residual(u_c):
            """Global residual in ``cfg.residual_metric`` semantics
            (see _residual_reduce)."""
            u_1 = extend_with_halo(u_c, 1)
            r = jnp.clip(
                (
                    wl_1 * jnp.roll(u_1, 1, -1)
                    + bh_1 * jnp.roll(u_1, -1, -1)
                    + wu_1 * jnp.roll(u_1, 1, -2)
                    + bv_1 * jnp.roll(u_1, -1, -2)
                )
                * inv_1,
                0.0,
                255.0,
            )
            d = jnp.abs(crop_halo(r, 1) - u_c)
            return _residual_reduce(d, m, cfg, batched)

        if not cfg.early_exit:
            return (
                run_chunk(u, iters, jnp.int32(0)),
                jnp.int32(iters),
                jnp.float32(jnp.inf),
            )

        def cond(state):
            u_c, i, res = state
            return (i + chunk <= iters) & (res >= tol)

        def body(state):
            u_c, i, _ = state
            u_c = run_chunk(u_c, chunk, i)
            return u_c, i + chunk, local_residual(u_c)

        return lax.while_loop(
            cond, body, (u, jnp.int32(0), jnp.float32(jnp.inf))
        )

    spec = P("batch", "dy", "dx") if batched else P("dy", "dx")
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec,) * 5,
        out_specs=(spec, P(), P()),
        check_vma=False,
    )


def _batched_edge_weights(gray, depth, level, max_level, cfg):
    if gray.ndim == 2:
        return edge_weights(gray, depth, level, max_level, cfg)
    return jax.vmap(lambda g, d: edge_weights(g, d, level, max_level, cfg))(gray, depth)


def solve_level_sharded(
    depth: jnp.ndarray,
    mask: jnp.ndarray,
    gray: jnp.ndarray,
    level: int,
    max_level: int,
    iters: int,
    mesh: Mesh,
    cfg: DiffusionConfig = DiffusionConfig(),
    halo: int = DEFAULT_HALO,
    return_info: bool = False,
) -> jnp.ndarray:
    """Sharded equivalent of core.solver.solve_level: weights from the
    incoming depth, pad to the mesh grid, iterate with halo exchange, crop.

    Accepts (H, W) arrays or (B, H, W) batches (the batched step's in-shard
    path). Solvers: jacobi_chebyshev (reference) and red_black (+ early
    exit with a globally agreed pmax residual).

    ``return_info=True`` returns ``(out, iters_done, residual)`` instead of
    ``out`` — the early-exit observability probe (iters_done < iters proves
    the globally-agreed exit actually fired; the driver dryrun asserts
    exactly this, and iters_done == iters whenever the full budget ran,
    including when the truncated final chunk runs outside the residual
    loop). ``residual`` is the value at the LAST residual check — when the
    truncated tail ran afterwards it is stale by up to
    residual_check_every-1 iterations (so residual >= tolerance alongside
    iters_done == iters does NOT mean the final state failed to converge).
    Both solvers (jacobi_chebyshev and red_black) honor
    ``cfg.early_exit``; with it off, iters_done == iters and the residual
    is +inf (no residual loop ran)."""
    if cfg.solver not in _SHARDED_SOLVERS:
        raise NotImplementedError(
            f"multi-chip path implements solvers {_SHARDED_SOLVERS}, got "
            f"{cfg.solver!r}; use the single-chip pipeline for 'jacobi'"
        )
    _check_route(cfg)
    batched = depth.ndim == 3
    h, w = depth.shape[-2:]
    dy, dx = mesh.shape["dy"], mesh.shape["dx"]
    wts = _batched_edge_weights(gray, depth, level, max_level, cfg)

    hp, wp = _pad_up(h, dy), _pad_up(w, dx)
    lead = [(0, 0)] * (depth.ndim - 2)
    pad = lambda a, fill: jnp.pad(
        a, lead + [(0, hp - h), (0, wp - w)], constant_values=fill
    )
    u = pad(depth.astype(jnp.float32), 0.0)
    m = pad(mask, True)  # pad pixels are Dirichlet-pinned at 0
    # Packed symmetric planes: bh = pair weight (x,x+1) = wr; bv = wd.
    planes = [pad(p, 0.0) for p in (wts.wr, wts.wd, wts.inv_count)]

    if cfg.solver == "red_black":
        fn = _sharded_level_rb_fn(mesh, halo, iters, cfg, batched)
        out, done, res = fn(u, *planes, m)
        out = out[..., :h, :w]
        if not cfg.early_exit:
            return (out, done, res) if return_info else out
        # Truncated final chunk (iters not divisible by the check cadence):
        # identical tail to the single-chip path, as plain (GSPMD-sharded)
        # XLA ops with a dynamic trip count, omegas indexed by the global
        # iteration so the rb_omegas recurrence continues seamlessly.
        from ..core.solver import rb_omegas, red_black_iter, red_black_parity

        om_full = jnp.asarray(rb_omegas(max(iters, 1), cfg))
        rem = jnp.maximum(jnp.int32(iters) - done, 0)
        red = red_black_parity(h, w)
        step = (
            (lambda v, j: jax.vmap(
                lambda vi, mi, *ws: red_black_iter(
                    vi, mi, type(wts)(*ws), red, om_full[j, 0], om_full[j, 1]
                )
            )(v, mask, *wts))
            if batched
            else (lambda v, j: red_black_iter(
                v, mask, wts, red, om_full[j, 0], om_full[j, 1]
            ))
        )
        tail = lambda v: lax.fori_loop(
            done, jnp.int32(iters), lambda j, x: step(x, j), v
        )
        tol = jnp.float32(cfg.tolerance) * jnp.float32(255.0)
        ran_tail = (res >= tol) & (rem > 0)
        out = lax.cond(ran_tail, tail, lambda v: v, out)
        # When the tail runs, the FULL budget ran: report iters_done=iters
        # so the documented probe (iters_done < iters <=> the exit fired)
        # stays truthful for budgets not divisible by the check cadence
        # (e.g. iters=25, cadence 8: the while_loop stops at 24 and the
        # tail runs the last iteration — pre-fix this returned 24 and a
        # caller concluded the exit fired when it had not). The returned
        # residual is the one measured at the LAST residual check, i.e.
        # before the tail iterations.
        done = jnp.where(ran_tail, jnp.int32(iters), done)
        return (out, done, res) if return_info else out

    prev0 = jnp.zeros_like(u)
    fn = _sharded_level_fn(mesh, halo, iters, cfg, batched)
    out, prev, done, res = fn(u, prev0, *planes, m)
    out = out[..., :h, :w]
    if not cfg.early_exit:
        return (out, done, res) if return_info else out
    # Truncated final chunk: same contract as the red-black branch above —
    # plain (GSPMD-sharded) XLA sweeps with a dynamic trip count carrying
    # (u, prev), omegas indexed by the global iteration so the Wang
    # recurrence continues seamlessly.
    from ..core.solver import chebyshev_omegas, jacobi_sweep

    prev = prev[..., :h, :w]
    om_full = jnp.asarray(chebyshev_omegas(max(iters, 1), cfg))
    gamma = jnp.float32(cfg.chebyshev_gamma)
    rem = jnp.maximum(jnp.int32(iters) - done, 0)

    def one(j, v, p, mk, w):
        r = jacobi_sweep(v, w)
        o = om_full[j] * (gamma * (r - v) + v - p) + p
        return jnp.where(mk, v, o), v

    step = (
        (lambda s, j: tuple(jax.vmap(
            lambda vi, pi, mi, *ws: one(j, vi, pi, mi, type(wts)(*ws))
        )(s[0], s[1], mask, *wts)))
        if batched
        else (lambda s, j: one(j, s[0], s[1], mask, wts))
    )
    tail = lambda s: lax.fori_loop(
        done, jnp.int32(iters), lambda j, st: step(st, j), s
    )
    tol = jnp.float32(cfg.tolerance) * jnp.float32(255.0)
    ran_tail = (res >= tol) & (rem > 0)
    out, _ = lax.cond(ran_tail, tail, lambda s: s, (out, prev))
    done = jnp.where(ran_tail, jnp.int32(iters), done)
    return (out, done, res) if return_info else out


def solve_cascade_sharded(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    depth_state: Sequence[jnp.ndarray],
    mesh: Mesh,
    cfg: DiffusionConfig = DiffusionConfig(),
    halo: int = DEFAULT_HALO,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Full coarse-to-fine solve with per-level shard/replicate choice.

    A level runs sharded when every chip's block is at least halo x halo;
    the tiny coarse levels run as ordinary global XLA ops (GSPMD replicates
    or subdivides them as it sees fit — they are microseconds of work).

    Accepts single images or batches (leading axis). Solvers:
    jacobi_chebyshev and red_black; the V-cycle scheme remains single-chip
    (its coarse-grid work is too small to shard profitably).
    """
    if cfg.solver not in _SHARDED_SOLVERS or cfg.multigrid != "cascadic":
        raise NotImplementedError(
            f"solve_cascade_sharded implements solvers {_SHARDED_SOLVERS} "
            f"with multigrid='cascadic', got ({cfg.solver!r}, "
            f"{cfg.multigrid!r}); use solve_vcycle_sharded for the V-cycle "
            f"scheme and the single-chip pipeline for 'jacobi'"
        )
    from ..core.solver import solve_level  # local import to avoid cycle

    batched = mask0.ndim == 3
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [g.shape[-2:] for g in gray_pyr]
    dy, dx = mesh.shape["dy"], mesh.shape["dx"]

    _ann_down = (
        (lambda m, v, s: jax.vmap(lambda mi, vi: annotation_pyr_down(mi, vi, s))(m, v))
        if batched
        else annotation_pyr_down
    )
    _pyr_up = (
        (lambda d, s: jax.vmap(lambda di: pyr_up(di, s))(d)) if batched else pyr_up
    )
    _solve_level_xla = (
        (lambda d, m, g, lv, it: jax.vmap(
            lambda di, mi, gi: solve_level(di, mi, gi, lv, L, it, cfg)
        )(d, m, g))
        if batched
        else (lambda d, m, g, lv, it: solve_level(d, m, g, lv, L, it, cfg))
    )

    masks = [mask0]
    values = [value0]
    for l in range(1, levels):
        m, v = _ann_down(masks[-1], values[-1], sizes[l])
        masks.append(m)
        values.append(v)

    state = list(depth_state)
    state[L] = seed_depth(state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        h, w = sizes[level]
        if h // dy >= halo and w // dx >= halo and (dy > 1 or dx > 1):
            state[level] = solve_level_sharded(
                state[level], masks[level], gray_pyr[level], level, L, iters,
                mesh, cfg, halo,
            )
        else:
            state[level] = _solve_level_xla(
                state[level], masks[level], gray_pyr[level], level, iters
            )
        if level > 0:
            up = _pyr_up(state[level], sizes[level - 1])
            state[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
    return state[0], tuple(state)


def solve_vcycle_sharded(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    depth_state: Sequence[jnp.ndarray],
    mesh: Mesh,
    cfg: DiffusionConfig = DiffusionConfig(),
    halo: int = DEFAULT_HALO,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Multi-device V-cycle (BASELINE config #4): sharded cascadic warm
    start (halo-block sweeps under shard_map), then the error-correction
    cycles as plain global XLA ops — pure stencils/reductions that GSPMD
    partitions over the mesh on its own (it inserts the one-pixel halo
    exchanges a 5-point stencil needs), so the polish phase requires no
    explicit communication code at all. Accepts single images or batches.
    """
    import dataclasses

    from ..core.multigrid import vcycle_polish

    warm_iters = max(
        int(cfg.max_iterations * cfg.vcycle_warm_fraction), 4 * cfg.chebyshev_s
    )
    warm_cfg = dataclasses.replace(
        cfg, max_iterations=warm_iters, multigrid="cascadic"
    )
    _, state = solve_cascade_sharded(
        gray_pyr, mask0, value0, depth_state, mesh, warm_cfg, halo
    )
    if mask0.ndim == 3:
        u = jax.vmap(
            lambda gp, m, v, ui: vcycle_polish(gp, m, v, ui, cfg)
        )(gray_pyr, mask0, value0, state[0])
    else:
        u = vcycle_polish(gray_pyr, mask0, value0, state[0], cfg)
    return u, (u,) + tuple(state[1:])


def batched_step(
    mesh: Mesh,
    rows: int,
    cols: int,
    cfg: DiffusionConfig = DiffusionConfig(),
    effect: int = fx.EFFECT_HAZE,
    halo: int = DEFAULT_HALO,
):
    """The framework's full multi-device step: data-parallel over a batch
    of images ('batch' axis), spatially sharded within each image
    ('dy','dx').

    Returns (jitted_fn, make_example_args): fn(rgb_batch, mask_batch,
    value_batch, depth_state_batch) -> (depth_batch, new_state, effect_batch).

    The solve levels shard over all three mesh axes with the local batch
    as a leading in-shard axis. The glue (gray pyramid, annotation
    pyramids, pyrUp, effects) runs as batched global XLA ops that GSPMD
    partitions along 'batch'.
    """
    from ..core.color import rgb_to_gray
    from ..core.multigrid import build_gray_pyramid, initial_depth_state

    _check_route(cfg)
    driver = solve_vcycle_sharded if cfg.multigrid == "vcycle" else solve_cascade_sharded
    # Effects run as vmapped GLOBAL ops that GSPMD partitions over the mesh.
    render = lambda rgb, gray0, depth0: jax.vmap(
        lambda r, g, d: fx.apply_effect(effect, r, g, d, cfg)
    )(rgb, gray0, depth0)

    def step(rgb, mask, value, depth_state):
        gray0 = jax.vmap(rgb_to_gray)(rgb)
        gpyr = jax.vmap(lambda g: build_gray_pyramid(g, cfg))(gray0)
        depth0, new_state = driver(
            gpyr, mask, value, depth_state, mesh, cfg, halo
        )
        out = render(rgb, gray0, jnp.clip(depth0, 0.0, 255.0))
        return depth0, new_state, out

    def shardings():
        # Input shardings are the initial PLACEMENT only — the solve pads
        # and re-shards explicitly inside (solve_level_sharded). jit rejects
        # a spec whose axis doesn't divide the dim, and the dataset is full
        # of odd shapes (853x1280 images; any odd pyramid level), so spatial
        # axes are requested only where they divide; GSPMD redistributes the
        # rest on first use.
        dy, dx = mesh.shape["dy"], mesh.shape["dx"]

        def spec(hh, ww, *extra):
            return P(
                "batch",
                "dy" if hh % dy == 0 else None,
                "dx" if ww % dx == 0 else None,
                *extra,
            )

        img = NamedSharding(mesh, spec(rows, cols))
        in_sh = (
            NamedSharding(mesh, spec(rows, cols, None)),  # rgb (B,H,W,3)
            img,  # mask
            img,  # value
            tuple(
                NamedSharding(mesh, spec(*cfg.level_size(rows, cols, lv)))
                for lv in range(cfg.num_levels(rows, cols))
            ),
        )
        return in_sh

    jitted = jax.jit(step, in_shardings=shardings())

    def make_example_args(batch: int | None = None):
        b = batch or mesh.shape["batch"]
        rng = np.random.default_rng(0)
        rgb = jnp.asarray(rng.integers(0, 256, (b, rows, cols, 3), dtype=np.uint8))
        mask = np.zeros((b, rows, cols), bool)
        value = np.zeros((b, rows, cols), np.uint8)
        mask[:, rows // 4, cols // 4] = True
        value[:, rows // 4, cols // 4] = 254
        mask[:, 3 * rows // 4, 3 * cols // 4] = True
        state = tuple(
            jnp.zeros((b,) + s.shape, jnp.float32) + jnp.float32(cfg.depth_init)
            for s in initial_depth_state(rows, cols, cfg)
        )
        return jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(value), state

    return jitted, make_example_args
