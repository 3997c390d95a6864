"""Cold-start benchmark: time-to-first-depth in a FRESH process.

The interactive contract the reference ships (instant start: main() loads,
allocates, and is solving within the first UI tick — src/main.cpp:64-178)
maps here to the fast_start staged path: per-level programs compile in
parallel and serve the first solve while the fused whole-cascade program
compiles in the background (pipeline.py:327-356, PERF.md "Startup").

This harness measures, in a fresh python process at the headline 1080p
geometry with fast_start ON:

- ``import_s``        process start -> framework imported, backend up
- ``first_solve_s``   annotation ready -> first depth-u8 readback complete
                      (the staged path; the number a user FEELS at startup)
- ``time_to_first_depth_s``  process start -> that same readback (includes
                      imports + pyramid build + staged compile)
- ``fused_switch_s``  process start -> the background fused executable
                      landed (solves switch to one-dispatch frames); null
                      if it hasn't landed within the wait cap

Run it as its own process (one process per card), never beside another
JAX process on the same card. Content is the seeded synthetic pair of
tests/golden/synthetic.py. Fails when JAX finds no GPU.

Prints ONE JSON line on stdout, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

T_PROC = time.perf_counter()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    os.environ.setdefault("RTDD_FAST_START", "1")
    wait_cap = 300.0
    if "--fused-wait" in sys.argv:
        wait_cap = float(sys.argv[sys.argv.index("--fused-wait") + 1])

    import numpy as np

    from bench import gpu_or_exit, synthetic_frame
    from realtimedepthdiffusion.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    platform, kind, count, card = gpu_or_exit()

    import jax.numpy as jnp

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.pipeline import DepthPipeline

    cfg = DiffusionConfig(fast_start=True)
    rgb, mask, value = synthetic_frame("1080p")
    h, w = mask.shape
    t_import = time.perf_counter() - T_PROC
    log(f"{card}: import+backend {t_import:.2f}s")

    pipe = DepthPipeline(h, w, cfg)
    pipe.prewarm_async()  # the session constructor's kick (session.py:53)
    rgb_d, gpyr = pipe.prepare_image(rgb)

    t0 = time.perf_counter()
    depth, state = pipe.solve(
        gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state()
    )
    u8 = np.asarray(pipe.depth_u8(depth))  # host readback completes the frame
    first_solve_s = time.perf_counter() - t0
    ttfd_s = time.perf_counter() - T_PROC
    assert u8.shape == (h, w) and u8[mask].size  # a real depth map came back
    log(f"first solve (staged): {first_solve_s:.2f}s; "
        f"time-to-first-depth: {ttfd_s:.2f}s")

    fused_switch_s = None
    if pipe.wait_fused(timeout=wait_cap):
        fused_switch_s = time.perf_counter() - T_PROC
        log(f"fused executable landed at {fused_switch_s:.2f}s")
    else:
        log(f"fused compile did not land within {wait_cap:.0f}s (reported null)")

    print(json.dumps({
        "metric": "1080p cold start: fresh-process time-to-first-depth "
                  "(fast_start staged path)",
        "value": ttfd_s,
        "unit": "s",
        "card": card,
        "device": {"platform": platform, "kind": kind, "count": count},
        "detail": {
            "import_s": t_import,
            "first_solve_s": first_solve_s,
            "time_to_first_depth_s": ttfd_s,
            "fused_switch_s": fused_switch_s,
        },
    }))


if __name__ == "__main__":
    main()
