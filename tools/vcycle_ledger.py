"""V-cycle value ledger (round-4 verdict task #6): what does BASELINE
config #4 buy over the reference's cascadic scheme, per millisecond?

For each dataset pair this runs three arms on the active device:

  A. cascadic @ the default 1000-iteration budget (the reference scheme,
     src/main.cpp:232-295),
  B. vcycle   @ its default (full cascadic warm start + cfg.vcycles
     error-correction cycles, core/multigrid.py),
  C. cascadic @ a RAISED budget chosen to match arm B's measured wall
     (the "just run the cascade longer" null hypothesis),

and reports per arm: per-frame ms (K-chained: (t(K) - t(1)) / (K - 1)),
final RMS residual over non-scribble pixels, and normalized RMSE against
an 8x-budget cascadic truth. If the V-cycle earns its config it must beat
arm C (equal wall) on residual/RMSE, not merely arm A (less wall).

Usage (GPU):  python tools/vcycle_ledger.py [--pairs N] [--k 8]
Output: a markdown table on stdout (paste into PERF.md) + JSON on stderr.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from realtimedepthdiffusion.utils.cache import enable_compilation_cache  # noqa: E402


def main() -> None:
    enable_compilation_cache()

    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax import lax

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import multigrid, solver
    from realtimedepthdiffusion.core.color import rgb_to_gray
    from realtimedepthdiffusion.core.weights import edge_weights
    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    n_pairs = None
    if "--pairs" in sys.argv:
        n_pairs = int(sys.argv[sys.argv.index("--pairs") + 1])
    K = 8
    if "--k" in sys.argv:
        K = int(sys.argv[sys.argv.index("--k") + 1])

    cfg0 = DiffusionConfig()

    def build(rgb):
        g0 = rgb_to_gray(jnp.asarray(rgb))
        return jax.jit(
            lambda g: multigrid.build_gray_pyramid(g, cfg0)
        )(g0)

    def solve_fn(cfg, h, w, gpyr, mask_d, value_d):
        """jitted: solve from the COLD initial state (fresh frame)."""
        driver = (
            multigrid.solve_vcycle if cfg.multigrid == "vcycle"
            else multigrid.solve_cascade
        )
        state0 = multigrid.initial_depth_state(h, w, cfg)

        @jax.jit
        def one(eps):
            st = tuple(s + eps for s in state0)
            d, _ = driver(gpyr, mask_d, value_d, st, cfg)
            return d

        @jax.jit
        def chained(eps):
            def body(i, e):
                d = one(e)
                return d[0, 0] * jnp.float32(0.0)

            return lax.fori_loop(0, K, body, eps)

        return one, chained

    def timed(one, chained):
        # Each timing ends in a host fetch of the result.
        z = jnp.float32(0.0)
        float(jnp.sum(one(z)))  # compile + warm
        float(jnp.asarray(chained(z)))

        def env(f, reduce, n=5):
            best = float("inf")
            for _ in range(n):
                t0 = time.perf_counter()
                float(reduce(f(z)))
                best = min(best, time.perf_counter() - t0)
            return best * 1000.0

        t1 = env(one, jnp.sum)
        tk = env(chained, lambda x: x)
        return max((tk - t1) / (K - 1), 1e-6)

    pairs = sorted(glob.glob("/root/reference/dataset/images/*.jpg"))
    if n_pairs:
        pairs = pairs[:n_pairs]

    print("| pair | size | arm | ms/frame | rms residual | rmse vs 8x truth |")
    print("|---|---|---|---|---|---|")
    out = []
    for img_path in pairs:
        name = os.path.splitext(os.path.basename(img_path))[0]
        ann_path = f"/root/reference/dataset/annotations/{name}.png"
        if not os.path.exists(ann_path):
            continue
        rgb = imread_rgb(img_path)
        mask, value = load_annotation(ann_path)
        h, w = rgb.shape[:2]
        gpyr = build(rgb)
        mask_d, value_d = jnp.asarray(mask), jnp.asarray(value)
        wts0 = edge_weights(gpyr[0], None, 0, 0, cfg0)

        def run(cfg):
            one, chained = solve_fn(cfg, h, w, gpyr, mask_d, value_d)
            d = np.asarray(one(jnp.float32(0.0)))
            ms = timed(one, chained)
            res = float(
                solver.residual_rms(jnp.asarray(d), mask_d, wts0)
            )
            return d, ms, res

        truth, _, _ = run(dataclasses.replace(cfg0, max_iterations=8000))

        def rmse(d):
            return float(np.sqrt(np.mean(((d - truth) / 255.0) ** 2)))

        d_a, ms_a, res_a = run(cfg0)
        d_b, ms_b, res_b = run(dataclasses.replace(cfg0, multigrid="vcycle"))
        # Arm C: cascadic budget scaled to the V-cycle's wall.
        scale = max(ms_b / ms_a, 1.0)
        it_c = int(round(cfg0.max_iterations * scale / 125.0) * 125) or 1000
        d_c, ms_c, res_c = run(
            dataclasses.replace(cfg0, max_iterations=it_c)
        )
        rows = [
            ("cascadic@1000", ms_a, res_a, rmse(d_a)),
            ("vcycle(default)", ms_b, res_b, rmse(d_b)),
            (f"cascadic@{it_c}", ms_c, res_c, rmse(d_c)),
        ]
        for arm, ms, res, rm in rows:
            print(f"| {name} | {h}x{w} | {arm} | {ms:.2f} | {res:.4f} "
                  f"| {rm:.4f} |")
        sys.stdout.flush()
        out.append({"pair": name, "size": [h, w], "arms": [
            {"arm": a, "ms": round(m, 3), "rms_residual": round(r, 5),
             "rmse_vs_truth": round(q, 5)} for a, m, r, q in rows
        ]})
    print(json.dumps(out), file=sys.stderr)


if __name__ == "__main__":
    main()
