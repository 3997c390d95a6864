"""Localized incremental re-solve around a dirty region (live editing path).

The reference re-runs the full coarse-to-fine solve on every frame under
--live (src/main.cpp:232-295); round 1 of this framework cut the cost with a
warm start + smaller global budget. This module makes the incremental path
actually *local*: after a brush stroke, only a fixed-size window centered on
the dirty rect is re-solved at the fine pyramid levels, with the window's
1-pixel border ring frozen (Dirichlet) at the current depth — "solve the
dirty region, warm everywhere else". Coarse levels, whose whole extent fits
the (level-scaled) window, take a full warm re-solve; no pyrUp overwrite, so
the converged fine-state away from the edit is untouched.

Far field: a new scribble changes the depth map GLOBALLY (diffusion has no
finite support), so a purely local window solve would leave a seam at the
window border. The coarse levels capture that global change cheaply; each
finer level receives it as a pyrUp'd CORRECTION DELTA (new - old coarse
state) added across the whole level before its window solve — so the frozen
window ring carries the far-field and the outside-window region moves with
the coarse solution, while fine-scale relaxation happens only inside the
window. Linearity of the (unclamped, off-Dirichlet) operator makes the
correction first-order exact; tests/test_incremental.py bounds the residual
RMSE against a full re-solve.

Everything is one jitted program: window sizes are static (config
``incremental_window``, halved per level); the window POSITION is dynamic
(lax.dynamic_slice/dynamic_update_slice, whose automatic start clamping
keeps the window in-bounds near image edges).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
from jax import lax

from ..config import DiffusionConfig
from ..ops.dispatch import solve_level
from .annotation import seed_depth
from .multigrid import build_annotation_pyramids
from .pyramid import pyr_up


def _ring(win: int) -> jnp.ndarray:
    """Boolean border ring of a win x win window."""
    yy = lax.broadcasted_iota(jnp.int32, (win, win), 0)
    xx = lax.broadcasted_iota(jnp.int32, (win, win), 1)
    return (yy == 0) | (yy == win - 1) | (xx == 0) | (xx == win - 1)


def solve_incremental(
    gray_pyr: Sequence[jnp.ndarray],
    mask0: jnp.ndarray,
    value0: jnp.ndarray,
    depth_state: Sequence[jnp.ndarray],
    center_yx: jnp.ndarray,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """Warm, windowed re-solve of an edit at ``center_yx`` (L0 coords, (2,)
    int32). Iteration budgets: the windowed fine levels get
    ``incremental_iterations`` at level 0, halved per coarser windowed level
    (the deep work goes where the new fine-scale detail is); the full
    coarse levels keep the reference cascade schedule (they are nearly
    free). Returns (depth0, new_state)."""
    levels = len(gray_pyr)
    L = levels - 1
    inc = cfg.incremental_iterations if cfg.incremental_iterations > 0 else cfg.max_iterations

    masks, values = build_annotation_pyramids(mask0, value0, cfg)
    state = list(depth_state)

    delta = None  # coarse-level correction (new - old), pyrUp'd downward
    for level in range(L, -1, -1):
        h, w = gray_pyr[level].shape
        win = cfg.incremental_window >> level
        old = state[level]

        # Window only the expensive FINE levels (both `win` and the level
        # dims halve per level, so a size ratio would make the same choice
        # everywhere); every coarser level takes a full warm re-solve at
        # the FULL cascade budget — they are small (the coarsest takes the
        # one-launch GPU kernel) and carry the edit's entire far field, so
        # skimping there is the wrong trade.
        windowed = level < cfg.incremental_window_levels and win < min(h, w)
        if not windowed:
            iters = cfg.level_iterations(levels, level)
            # Inject the coarser level's correction before the warm re-solve:
            # this level's sweep budget (e.g. 125 at L1 of a 1080p cascade)
            # propagates information only ~budget pixels, so an edit's far
            # field must ARRIVE in the initial state rather than be
            # rediscovered. Without this, a far-from-annotations stroke
            # measured up to 0.14 normalized RMSE vs the full re-solve
            # (tools/incremental_report.py round-4 ledger); with it the
            # relaxation only polishes an already-correct global field.
            st = old if delta is None else old + pyr_up(delta, (h, w))
            st = seed_depth(st, masks[level], values[level])
            state[level] = solve_level(
                st, masks[level], gray_pyr[level], level, L, iters, cfg
            )
            delta = state[level] - old
            continue
        # Windowed (fine) levels: the incremental budget, halved per level
        # like the reference schedule.
        iters = max(inc >> level, 1)

        # Inject the coarse far-field correction everywhere, then re-pin the
        # scribbles exactly (the delta is ~0 at old Dirichlet pixels anyway).
        u = old if delta is None else old + pyr_up(delta, (h, w))
        u = seed_depth(u, masks[level], values[level])
        # A few GLOBAL sweeps refine the (smooth) injected correction along
        # this level's image edges — without them the far field off-window
        # ignores fine-scale structure. They cost one strip-kernel launch.
        n_glob = min(int(cfg.incremental_global_smooth), iters)
        if n_glob > 0:
            u = solve_level(u, masks[level], gray_pyr[level], level, L, n_glob, cfg)

        oy = (center_yx[0] >> level) - win // 2
        ox = (center_yx[1] >> level) - win // 2
        origin = (oy, ox)  # dynamic_slice clamps to keep the window in-bounds
        u_w = lax.dynamic_slice(u, origin, (win, win))
        m_w = lax.dynamic_slice(masks[level], origin, (win, win))
        g_w = lax.dynamic_slice(gray_pyr[level], origin, (win, win))

        # Freeze the window border at the corrected depth: Dirichlet ring
        # carrying the far-field into the window solve.
        m_solve = m_w | _ring(win)
        u_w = solve_level(u_w, m_solve, g_w, level, L, iters, cfg)
        state[level] = lax.dynamic_update_slice(u, u_w, origin)
        delta = state[level] - old

    return state[0], tuple(state)
