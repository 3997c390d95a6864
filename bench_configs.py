"""Extended benchmarks: the five BASELINE.json configs, one JSON line each.

(The driver contract file is bench.py — ONE line, headline metric. This
suite exists for completeness/reporting; see PERF.md.)

1. Jacobi scribble-diffusion, fixed iterations, dataset pair
2. Red-black Gauss-Seidel with residual-tolerance early exit
3. Edge-aware anisotropic Laplacian weights from image gradients
4. Full multigrid V-cycle at 1080p
5. Live loop: incremental scribble update + fused effect

Each number is the median wall time of one step dispatched and waited
for on its own (block_until_ready), after a warm-up step, on the GPU (it
fails without one); every line names the card and its power limit.
"""

from __future__ import annotations

import json
import statistics
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from bench import gpu_or_exit, synthetic_frame
    from realtimedepthdiffusion.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    _, _, _, card = gpu_or_exit()

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.core import multigrid, solver
    from realtimedepthdiffusion.core.color import rgb_to_gray
    from realtimedepthdiffusion.core.weights import edge_weights

    rgb, mask, value = synthetic_frame("1080p")
    h, w = mask.shape
    rgb_d = jnp.asarray(rgb)
    mask_d, value_d = jnp.asarray(mask), jnp.asarray(value)
    gray0 = rgb_to_gray(rgb_d)

    def emit(name, ms, unit="ms", extra=None):
        rec = {"metric": name, "value": float(ms), "unit": unit, "card": card}
        if extra:
            rec.update(extra)
        print(json.dumps(rec), flush=True)

    def median_ms(step, state0, n=24):
        """Median ms of one jitted ``step`` over ``n`` runs after a warm-up."""
        f = jax.jit(step)
        jax.block_until_ready(f(state0))
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(f(state0))
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def cascade_step(cfg, gp):
        def step(state):
            _, s = multigrid.solve_cascade(gp, mask_d, value_d, state, cfg)
            return s
        return step

    # 1. Plain Jacobi cascade, fixed iterations.
    cfg1 = DiffusionConfig(solver="jacobi")
    gp = jax.jit(lambda g: multigrid.build_gray_pyramid(g, cfg1))(gray0)
    jax.block_until_ready(gp)
    st = multigrid.initial_depth_state(h, w, cfg1)
    ms = median_ms(cascade_step(cfg1, gp), st)
    emit("config1 jacobi cascade 1080p (fixed 1937 sweeps)", ms)

    # 2. Red-black GS + residual early exit (tolerance honored).
    # tolerance 1e-3 on the RMS residual metric: the operating point of the
    # CPU quality sweep (RMSE-to-truth across the dataset, PERF.md).
    cfg2 = DiffusionConfig(solver="red_black", early_exit=True, tolerance=1e-3,
                           residual_check_every=25)
    ms = median_ms(cascade_step(cfg2, gp), multigrid.initial_depth_state(h, w, cfg2))
    emit("config2 red-black GS + early exit 1080p", ms)

    # 3. Edge-aware weight computation from image gradients (finest level).
    def wstep(d):
        wts = edge_weights(gray0, d, 0, 4, cfg1)
        return d + wts.inv_count * jnp.float32(1e-9)
    ms = median_ms(wstep, st[0])
    emit("config3 edge-aware Laplacian weights 1080p", ms)

    # 4. Full V-cycle at 1080p.
    cfg4 = DiffusionConfig(multigrid="vcycle")
    def vstep(state):
        _, s = multigrid.solve_vcycle(gp, mask_d, value_d, state, cfg4)
        return s
    ms = median_ms(vstep, multigrid.initial_depth_state(h, w, cfg4))
    emit("config4 full V-cycle 1080p (warm cascade + 2 cycles)", ms,
         extra={"within_16ms_budget": bool(ms < 16.0)})

    # 5. Live loop: LOCALIZED incremental re-solve (dirty-window solve at the
    # fine levels + coarse far-field delta, core/incremental.py) + fused haze.
    from realtimedepthdiffusion.core.incremental import solve_incremental

    cfg5 = DiffusionConfig(incremental_iterations=120)
    _, warm = jax.jit(
        lambda m, v, s: multigrid.solve_cascade(gp, m, v, s, cfg5)
    )(mask_d, value_d, multigrid.initial_depth_state(h, w, cfg5))
    center = jnp.asarray([140, 230], jnp.int32)  # at the first scribble block
    def live_step(state):
        d0, s = solve_incremental(gp, mask_d, value_d, state, center, cfg5)
        out = fx.apply_effect(fx.EFFECT_HAZE, rgb_d, gray0,
                              jnp.clip(d0, 0.0, 255.0), cfg5)
        # tie the WHOLE effect output into the carried state (a single-pixel
        # tap would let XLA dead-code-eliminate most of the effect)
        s0 = s[0] + out.astype(jnp.float32).mean() * jnp.float32(1e-30)
        return (s0,) + tuple(s[1:])
    ms = median_ms(live_step, warm)
    emit("config5 live incremental update (windowed) + fused haze 1080p", ms)


if __name__ == "__main__":
    main()
