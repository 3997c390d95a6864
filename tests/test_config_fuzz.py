"""Cross-configuration fuzz: every (solver x multigrid x backend x effect)
routing combination the dispatch layer can take, on awkward shapes, must
produce a depth map that satisfies the framework's invariants:

- scribbled (Dirichlet) pixels keep their seeded value EXACTLY through the
  full coarse-to-fine solve (src/GPUSolver.cu:248 semantics),
- the field stays finite and within the solver's bounded range ([0,255]
  plus legal transient Chebyshev/SOR overshoot),
- the fused effect renders to a (H, W, 3) uint8 frame.

The per-feature suites verify each path's NUMERICS against the oracle;
this sweep targets the ROUTING GATES between them (the route table, the
kernel's fit rule, the early-exit and solver gates) — historically where
bugs hid, and combinations no focused test enumerates.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import synthetic_pair
from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import effects as fx
from realtimedepthdiffusion.pipeline import DepthPipeline

SOLVERS = ["jacobi_chebyshev", "jacobi", "red_black"]
MULTIGRIDS = ["cascadic", "vcycle"]
BACKENDS = ["xla", "pallas_interpret"]
EFFECTS = [fx.EFFECT_DEFOCUS, fx.EFFECT_DESATURATION, fx.EFFECT_HAZE]
SHAPES = [(33, 47), (64, 96), (51, 130)]

_ALL = list(itertools.product(SOLVERS, MULTIGRIDS, BACKENDS))


def _combo_id(c):
    (solver, mg, backend), shape, effect = c
    return f"{solver}-{mg}-{backend}-{shape[0]}x{shape[1]}-fx{effect}"


# Deterministic sample: every (solver, multigrid, backend) triple appears
# once, with shape and effect rotating through their cycles. The vcycle
# half rides in the slow set (the V-cycle is an off-default extension; its
# quality/routing anchors — test_multigrid.py, test_parallel.py — stay
# fast, and the full suite still fuzzes every combination).
COMBOS = [
    pytest.param(
        (t, SHAPES[i % len(SHAPES)], EFFECTS[i % len(EFFECTS)]),
        marks=[pytest.mark.slow] if t[1] == "vcycle" else [],
    )
    for i, t in enumerate(_ALL)
]


@pytest.mark.parametrize("combo", COMBOS, ids=_combo_id)
def test_solve_and_effect_invariants(combo, monkeypatch):
    (solver, mg, backend), (h, w), effect = combo
    # The kernel covers the fixed-count solver only: its interpreter combos
    # run fixed-count so the kernel actually runs; the XLA combos fuzz the
    # early-exit chunked while_loop paths (every solver honors it).
    kernel = backend == "pallas_interpret"
    cfg = DiffusionConfig(
        solver=solver,
        multigrid=mg,
        backend=backend,
        max_iterations=40,
        early_exit=not kernel,
        tolerance=1e-3,
    )
    from realtimedepthdiffusion.ops import coarse_sweep

    calls = []
    real = coarse_sweep.solve_level
    monkeypatch.setattr(coarse_sweep, "solve_level",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rgb, mask, value = synthetic_pair(h, w, seed=h * w)
    pipe = DepthPipeline(h, w, cfg)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    depth, _, art = pipe.solve_and_effect(
        effect, gpyr, rgb_d, jnp.asarray(mask), jnp.asarray(value),
        pipe.initial_state(),
    )
    depth = np.asarray(depth)
    art = np.asarray(art)

    assert np.isfinite(depth).all()
    assert depth.min() >= -40 and depth.max() <= 300  # bounded overshoot
    assert np.array_equal(depth[mask], value[mask].astype(np.float32))
    assert art.shape == (h, w, 3) and art.dtype == np.uint8
    assert bool(calls) is (kernel and solver == "jacobi_chebyshev")
