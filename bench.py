"""Frame benchmark on the GPU (prints ONE JSON line on stdout).

Measures ms per annotation update: a full coarse-to-fine solve (5 levels at
1080p, 1937 Jacobi+Chebyshev sweeps: 1000/500/250/125/62) PLUS the fused
DEFOCUS effect — the reference's most expensive kernel (O(k^2) gather,
src/GPUDepthEffect.cu:29-72), i.e. the WORST-CASE frame, the same work the
reference performs per frame under ``--live`` with refocus latched
(src/main.cpp:190-202,232-295). Content is the seeded synthetic pair of
tests/golden/synthetic.py (``--size 4k`` repeats it 2x2 to 2160x3840).

Each frame is dispatched and waited for (``block_until_ready``) on its own;
the median over ``--frames`` frames after one warm-up frame is reported, with
the card's name and power limit. Fails when JAX finds no GPU. Cold start is
its own invocation: ``python bench_cold.py`` (one process per card).

    python bench.py [--size 1080p|4k] [--frames 50] [--defocus-quality exact|auto|approx]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gpu_or_exit():
    """(platform, device_kind, count, 'name, power limit') of the card;
    exits non-zero when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return devs[0].platform, devs[0].device_kind, len(devs), card


def synthetic_frame(size: str):
    """(rgb, mask, value) of the seeded synthetic pair at 1080p or 4K."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    from synthetic import synthetic_1080p

    rgb, mask, value = synthetic_1080p()
    if size == "4k":
        up = lambda a: np.repeat(np.repeat(a, 2, 0), 2, 1)
        rgb, mask, value = up(rgb), up(mask), up(value)
    return rgb, mask, value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", choices=("1080p", "4k"), default="1080p")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--defocus-quality", choices=("exact", "auto", "approx"),
                    default="exact")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from realtimedepthdiffusion.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    platform, kind, count, card = gpu_or_exit()

    import jax
    import jax.numpy as jnp

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.pipeline import DepthPipeline

    rgb, mask, value = synthetic_frame(args.size)
    h, w = mask.shape
    cfg = DiffusionConfig(pallas_defocus_quality=args.defocus_quality,
                          fast_start=False)
    pipe = DepthPipeline(h, w, cfg)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = jnp.asarray(mask), jnp.asarray(value)

    def frame(state):
        out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)
        jax.block_until_ready(out)
        return out[1]

    t0 = time.perf_counter()
    state = frame(pipe.initial_state())
    log(f"{card}: compile + first frame {time.perf_counter() - t0:.2f} s")
    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        state = frame(state)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    levels = cfg.num_levels(h, w)
    sweeps = sum(cfg.level_iterations(levels, l) for l in range(levels))
    log(f"{card}: frame median {ms:.3f} ms, min {min(times):.3f} ms "
        f"over {len(times)} frames")
    print(json.dumps({
        "metric": f"{h}x{w} solve+defocus ms/frame, worst-case effect "
                  f"({sweeps} Chebyshev sweeps, {levels}-level cascade, "
                  f"{args.defocus_quality} defocus)",
        "value": ms,
        "unit": "ms",
        "card": card,
        "device": {"platform": platform, "kind": kind, "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
