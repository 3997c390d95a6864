"""Early-exit value report for the REFERENCE solver (jacobi_chebyshev) —
the round-4 verdict task #2 PERF row: what does honoring the tolerance the
reference ignores (src/main.cpp:264) buy, per tolerance, on the 12 pairs?

Arms per pair (full default schedule, active backend):
  fixed        — the fixed-iteration reference schedule,
  ee@1e-3/-4/-5 — residual early exit at that tolerance (RMS metric).

Reports per arm: per-frame ms (K-chained: (t(K) - t(1)) / (K - 1)) and normalized
RMSE vs the FIXED run (the quality cost of stopping early; 0 when the
tolerance never fires and the chunked loop runs the whole budget).

Run on the GPU:  python tools/early_exit_report.py [--k 8] [--pairs N]
Output: markdown table for PERF.md.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from realtimedepthdiffusion.utils.cache import enable_compilation_cache  # noqa: E402


def main() -> int:
    enable_compilation_cache()

    K = 8
    if "--k" in sys.argv:
        K = int(sys.argv[sys.argv.index("--k") + 1])
    n_pairs = None
    if "--pairs" in sys.argv:
        n_pairs = int(sys.argv[sys.argv.index("--pairs") + 1])

    import jax
    import jax.numpy as jnp
    from jax import lax

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import multigrid
    from realtimedepthdiffusion.core.color import rgb_to_gray
    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    cfg0 = DiffusionConfig()
    arms = [("fixed", cfg0)] + [
        (f"ee@{t:g}", dataclasses.replace(cfg0, early_exit=True, tolerance=t))
        for t in (1e-3, 1e-4, 1e-5)
    ]

    def solve_fns(cfg, h, w, gpyr, mask_d, value_d):
        state0 = multigrid.initial_depth_state(h, w, cfg)

        @jax.jit
        def one(eps):
            st = tuple(s + eps for s in state0)
            d, _ = multigrid.solve_cascade(gpyr, mask_d, value_d, st, cfg)
            return d

        @jax.jit
        def chained(eps):
            def body(i, e):
                return one(e)[0, 0] * jnp.float32(0.0)

            return lax.fori_loop(0, K, body, eps)

        return one, chained

    def timed(one, chained):
        # Each timing ends in a host fetch of the result.
        z = jnp.float32(0.0)
        float(jnp.sum(one(z)))
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

    hdr = " | ".join(f"{a} ms / rmse" for a, _ in arms)
    print(f"| pair | size | {hdr} |")
    print("|---|---|" + "---|" * len(arms))
    for img_path in pairs:
        name = os.path.splitext(os.path.basename(img_path))[0]
        ann = f"/root/reference/dataset/annotations/{name}.png"
        if not os.path.exists(ann):
            continue
        rgb = imread_rgb(img_path)
        mask, value = load_annotation(ann)
        h, w = rgb.shape[:2]
        gpyr = jax.jit(lambda g: multigrid.build_gray_pyramid(g, cfg0))(
            rgb_to_gray(jnp.asarray(rgb))
        )
        mask_d, value_d = jnp.asarray(mask), jnp.asarray(value)

        cells = []
        fixed_d = None
        for arm, cfg in arms:
            one, chained = solve_fns(cfg, h, w, gpyr, mask_d, value_d)
            d = np.asarray(one(jnp.float32(0.0)))
            ms = timed(one, chained)
            if fixed_d is None:
                fixed_d = d
                cells.append(f"{ms:.2f} / —")
            else:
                rmse = float(np.sqrt(np.mean(((d - fixed_d) / 255.0) ** 2)))
                cells.append(f"{ms:.2f} / {rmse:.4f}")
        print(f"| {name} | {h}x{w} | " + " | ".join(cells) + " |")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
