"""Multigrid drivers: the reference's cascadic coarse-to-fine scheme and a
full V-cycle extension.

Cascadic driver = rebuild of the solve pass in src/main.cpp:232-295:
downsample gray + annotation pyramids, seed the coarsest depth, then
coarse->fine: solve with iters = max_iterations/2^((L-1)-level), pyrUp the
depth into the next finer level and re-seed the scribbles. The entire pass —
pyramids, weights, ~1937 sweeps, upsampling — compiles into ONE XLA program
(the reference performs ~2000 kernel launches plus several host round-trips
per solve, SURVEY.md §3.2).

V-cycle (BASELINE.json config #4): textbook correction-scheme multigrid on
the edge-aware Laplacian, using the same pyramid geometry, a linear
(unclamped) Jacobi smoother, 2x2 full-weighting restriction and the Gaussian
pyrUp as prolongation.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import DiffusionConfig
from .annotation import annotation_pyr_down, seed_depth
from .pyramid import pyr_down_gray, pyr_down_gray_ceil, pyr_up
from .solver import edge_weights, jacobi_sweep_raw


def build_gray_pyramid(gray0: jnp.ndarray, cfg: DiffusionConfig) -> Tuple[jnp.ndarray, ...]:
    """Gray pyramid via repeated Gaussian pyrDown, consumed at floor sizes.

    gray_pyramid="opencv" (default, reference-faithful): the chain runs at
    OpenCV's ceil sizes exactly like the binary's always-taken CPU pyrDown
    fallback (bug #1, src/main.cpp:241-247), and each level is cropped to
    the floor size the solver indexes (the binary passes the floor-size
    depth mats' rows/cols with the ceil gray buffer's own pitch,
    src/main.cpp:266-268). gray_pyramid="floor" chains at floor sizes — a
    cleaner single convention whose coarse levels differ near the
    bottom/right border on odd-size levels (up to ~5e-3 depth RMSE on
    border-dominated pairs; see PARITY.md).

    The gray image never changes during a session, so unlike the reference —
    which rebuilds this every solve through a host round-trip — callers
    compute it once per image.
    """
    h, w = gray0.shape
    levels = cfg.num_levels(h, w)
    pyr = [gray0]
    if cfg.gray_pyramid == "opencv":
        full = gray0
        for l in range(1, levels):
            full = pyr_down_gray_ceil(full)
            th, tw = cfg.level_size(h, w, l)
            pyr.append(full[:th, :tw])
    elif cfg.gray_pyramid == "floor":
        for l in range(1, levels):
            th, tw = cfg.level_size(h, w, l)
            pyr.append(pyr_down_gray(pyr[-1])[:th, :tw])
    else:
        raise ValueError(
            f"unknown gray_pyramid {cfg.gray_pyramid!r}; expected 'opencv' or 'floor'"
        )
    return tuple(pyr)


def build_annotation_pyramids(
    mask0: jnp.ndarray, value0: jnp.ndarray, cfg: DiffusionConfig
) -> Tuple[Tuple[jnp.ndarray, ...], Tuple[jnp.ndarray, ...]]:
    """Scribble mask/value pyramids (GPUPyrDownAnnotation chain,
    src/main.cpp:239-255)."""
    h, w = mask0.shape
    levels = cfg.num_levels(h, w)
    masks = [mask0]
    values = [value0]
    for l in range(1, levels):
        m, v = annotation_pyr_down(masks[-1], values[-1], cfg.level_size(h, w, l))
        masks.append(m)
        values.append(v)
    return tuple(masks), tuple(values)


def initial_depth_state(rows: int, cols: int, cfg: DiffusionConfig) -> Tuple[jnp.ndarray, ...]:
    """Fresh per-level depth maps, initialized to depth_init = 255 (far)
    (src/main.cpp:135-136). This tuple is the persistent solver state that
    warm-starts subsequent solves, exactly like the reference's long-lived
    deviceDepthImage pyramid."""
    levels = cfg.num_levels(rows, cols)
    return tuple(
        jnp.full(cfg.level_size(rows, cols, l), cfg.depth_init, dtype=jnp.float32)
        for l in range(levels)
    )


def solve_cascade(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    depth_state: Sequence[jnp.ndarray],
    cfg: DiffusionConfig = DiffusionConfig(),
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """One full coarse-to-fine solve. Returns (depth0, new_depth_state).

    Jit this whole function (static shapes per image size); levels unroll at
    trace time, each level's sweep loop is a lax.fori_loop.
    """
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [g.shape for g in gray_pyr]

    masks = [mask0]
    values = [value0]
    for l in range(1, levels):
        m, v = annotation_pyr_down(masks[-1], values[-1], sizes[l])
        masks.append(m)
        values.append(v)

    # Lazy import: ops.dispatch routes each level along its route table
    # (the coarse-level GPU kernel where it applies, XLA elsewhere) without
    # a core->ops import cycle at module load.
    from ..ops import dispatch as _dispatch

    state = list(depth_state)
    state[L] = seed_depth(state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        state[level] = _dispatch.solve_level(
            state[level], masks[level], gray_pyr[level], level, L, iters, cfg
        )
        if level > 0:
            up = pyr_up(state[level], sizes[level - 1])
            state[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
    return state[0], tuple(state)


# ---------------------------------------------------------------------------
# Full V-cycle (correction scheme)
# ---------------------------------------------------------------------------


def _restrict(r: jnp.ndarray, out_shape: Tuple[int, int]) -> jnp.ndarray:
    """2x2 full-weighting restriction to floor-size coarse grid.

    Implemented as a reduce_window mean over 2x2 windows."""
    oh, ow = out_shape
    s = jax.lax.reduce_window(
        r[: 2 * oh, : 2 * ow],
        jnp.float32(0.0),
        jax.lax.add,
        window_dimensions=(2, 2),
        window_strides=(2, 2),
        padding="VALID",
    )
    return 0.25 * s


def _smooth_error(e, rhs, mask, wts, sweeps):
    """Jacobi on the error equation (I - M) e = rhs, e = 0 on scribbles."""
    for _ in range(sweeps):
        e = jnp.where(mask, 0.0, jacobi_sweep_raw(e, wts) + rhs)
    return e


def solve_vcycle(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    depth_state: Sequence[jnp.ndarray],
    cfg: DiffusionConfig = DiffusionConfig(),
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Full-resolution V-cycle solve (BASELINE.json config #4).

    Runs ``cfg.vcycles`` V-cycles directly at the finest level on the primal
    variable, after a cascadic warm start at a fraction of the iteration
    budget. Each cycle: pre-smooth, restrict the residual, recursively solve
    the (linear, unclamped) error equation on coarser grids, prolong and
    correct, post-smooth. Scribbled pixels are hard Dirichlet constraints at
    every level (error forced to 0 there).
    """
    # Cascadic warm start at cfg.vcycle_warm_fraction of the iteration
    # budget; the V-cycles then polish (default: full cascade + cycles).
    import dataclasses

    warm_iters = max(
        int(cfg.max_iterations * cfg.vcycle_warm_fraction), 4 * cfg.chebyshev_s
    )
    warm_cfg = dataclasses.replace(cfg, max_iterations=warm_iters)
    _, state = solve_cascade(gray_pyr, mask0, value0, depth_state, warm_cfg)
    u = vcycle_polish(gray_pyr, mask0, value0, state[0], cfg)
    state = (u,) + tuple(state[1:])
    return u, state


def vcycle_polish(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    u: jnp.ndarray,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> jnp.ndarray:
    """``cfg.vcycles`` error-correction V-cycles on a warm fine solution.

    Pure global jnp ops (stencils, reduce_window restriction, pyrUp
    prolongation, dot-product damping): runs as-is single-device, under
    jax.vmap for a batch, or GSPMD-partitioned over a mesh when its inputs
    carry shardings (parallel/sharded.solve_vcycle_sharded) — a 5-point
    stencil's halo exchange is exactly what GSPMD's windowed-op handling
    inserts, so no shard_map is needed here.
    """
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [g.shape for g in gray_pyr]

    masks = [mask0]
    values = [value0]
    for l in range(1, levels):
        m, v = annotation_pyr_down(masks[-1], values[-1], sizes[l])
        masks.append(m)
        values.append(v)

    # Per-level weights for the fine-state-dependent operator: computed once
    # from the warm-started fine solution restricted down the pyramid.
    wts = []
    d = u
    for l in range(levels):
        if l > 0:
            d = _restrict(d, sizes[l])
        wts.append(edge_weights(gray_pyr[l], d, l, L, cfg))

    def _apply_A(e, level):
        """A = I - M on the non-scribble set (e and A e are 0 on scribbles)."""
        return jnp.where(masks[level], 0.0, e - jacobi_sweep_raw(e, wts[level]))

    def _damped_add(e, corr, rhs_res, level):
        """e += alpha*corr with alpha = <r, A c>/<A c, A c>: the optimally
        damped coarse-grid correction. Guarantees the L2 residual never
        increases even though the rediscretized coarse operator only
        approximates the fine one (no Galerkin product is formed)."""
        corr = jnp.where(masks[level], 0.0, corr)
        ac = _apply_A(corr, level)
        denom = jnp.sum(ac * ac)
        alpha = jnp.where(denom > 0, jnp.sum(rhs_res * ac) / jnp.maximum(denom, 1e-30), 0.0)
        return e + alpha * corr

    def cycle_err(rhs, level):
        """Solve (I - M_level) e = rhs approximately; returns e."""
        e = jnp.zeros(sizes[level], dtype=jnp.float32)
        if level == L:
            return _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_coarse_iters)
        e = _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_pre_smooth)
        r = rhs - _apply_A(e, level)
        rc = jnp.where(masks[level + 1], 0.0, _restrict(r, sizes[level + 1]))
        ec = cycle_err(rc, level + 1)
        e = _damped_add(e, pyr_up(ec, sizes[level]), r, level)
        return _smooth_error(e, rhs, masks[level], wts[level], cfg.vcycle_post_smooth)

    for _ in range(cfg.vcycles):
        r = jnp.where(masks[0], 0.0, jacobi_sweep_raw(u, wts[0]) - u)
        e = cycle_err(r, 0)
        u = _damped_add(u, e, r, 0)
        u = jnp.clip(u, 0.0, 255.0)
    return u
