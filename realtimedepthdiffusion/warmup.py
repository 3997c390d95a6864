"""rtdd-warmup: seed the persistent XLA compilation cache for a set of
image shapes, so production cold starts become warm starts.

The reference binary ships precompiled CUDA kernels and opens its window in
under a second (src/main.cpp:64-178); a JAX process pays an XLA compile per
(shape, config) program. This tool compiles every product program for the
shapes you are about to serve INTO the persistent cache (utils/cache.py:
JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache), after which
depth-diffusion / rtdd-serve on those shapes start from disk:

    rtdd-warmup --size 1080p --size 4k --effect b
    rtdd-warmup --images dataset/images          # warm every distinct shape
    rtdd-warmup --size 1080p --profile fast --incremental 120

Programs warmed per shape: the fused solve, fused solve+effect for each
--effect, the staged fast-start programs, the gray pyramid, the u8/u16
depth converters, and (with --incremental) the windowed live re-solve.
Independent programs compile concurrently (--jobs, default 6): XLA compiles
release the GIL and overlap.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

_ALIASES = {
    "1080p": (1080, 1920),
    "720p": (720, 1280),
    "1440p": (1440, 2560),
    "4k": (2160, 3840),
    "2160p": (2160, 3840),
}


def parse_size(s: str) -> Tuple[int, int]:
    """'1080p' / '4k' aliases or explicit 'HxW' (rows x cols)."""
    v = s.lower().strip()
    if v in _ALIASES:
        return _ALIASES[v]
    try:
        h, w = v.split("x", 1)
        return int(h), int(w)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"size {s!r}: expected HxW or one of {sorted(_ALIASES)}"
        )


def shapes_from_images(images_dir: str) -> List[Tuple[int, int]]:
    """Distinct image shapes in a directory, from headers only (no pixel
    decode) — warms exactly the programs a serve run over it will need."""
    import os

    from .io import image_size

    shapes = []
    for f in sorted(os.listdir(images_dir)):
        if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg"):
            try:
                s = image_size(os.path.join(images_dir, f))
            except Exception as e:
                print(f"warning: {f}: {e}", file=sys.stderr)
                continue
            if s not in shapes:
                shapes.append(s)
    return shapes


def warm_shape(
    rows: int,
    cols: int,
    cfg,
    effects: List[int],
    incremental: bool,
    jobs: int = 6,
    log=print,
) -> float:
    """Compile every product program for one shape into the persistent
    cache; returns wall seconds. Programs already cached deserialize in
    ~seconds and are reported as such (the tool is idempotent)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from .pipeline import DepthPipeline, _StagedCascade

    pipe = DepthPipeline(rows, cols, cfg)
    gp, m0, v0, st = pipe._solve_structs()
    rgb = pipe._rgb_struct()
    center = jax.ShapeDtypeStruct((2,), jnp.int32)
    d0 = jax.ShapeDtypeStruct((rows, cols), jnp.float32)
    gray0 = jax.ShapeDtypeStruct((rows, cols), jnp.uint8)

    # Trace + lower EVERYTHING on this thread first: JAX tracing is not
    # safe to run concurrently (pipeline._kick docstring; the pool used to
    # lower in its workers). Lowering is sub-second per program; the XLA
    # .compile() calls — which release the GIL and dominate the wall — are
    # what the pool parallelizes.
    t_shape = time.perf_counter()
    lowered = [
        ("solve", pipe._solve.lower(gp, m0, v0, st)),
        ("gray_pyramid", pipe._gray_pyramid.lower(gray0)),
        ("depth_u8", pipe._to_u8.lower(d0)),
        ("depth_u16", pipe._to_u16.lower(d0)),
    ]
    for e in effects:
        lowered.append((
            f"solve+effect[{e}]",
            pipe._solve_and_effect.lower(e, gp, rgb, m0, v0, st),
        ))
        lowered.append((f"effect[{e}]", pipe._effect.lower(e, rgb, gray0, d0)))
    if incremental:
        lowered.append((
            "incremental",
            pipe._solve_incremental.lower(gp, m0, v0, st, center),
        ))
        for e in effects:
            lowered.append((
                f"incremental+effect[{e}]",
                pipe._solve_incremental_and_effect.lower(
                    e, gp, rgb, m0, v0, st, center
                ),
            ))
    if cfg.fast_start and cfg.multigrid != "vcycle":
        # The staged fast-start programs are cached too, so even the very
        # first frames of a cold process hit the disk cache.
        for i, lo in enumerate(_StagedCascade(rows, cols, cfg).lower_all()):
            lowered.append((f"staged[{i}]", lo))

    def run(named):
        name, lo = named
        t0 = time.perf_counter()
        lo.compile()
        dt = time.perf_counter() - t0
        log(f"  {rows}x{cols} {name}: {dt:.1f} s")
        return dt

    with ThreadPoolExecutor(max_workers=max(jobs, 1)) as ex:
        list(ex.map(run, lowered))
    return time.perf_counter() - t_shape


def main(argv: Optional[List[str]] = None) -> int:
    from .core import effects as fx
    from .serve import config_from_args

    p = argparse.ArgumentParser(prog="rtdd-warmup", description=__doc__)
    p.add_argument("--size", action="append", type=parse_size, default=[],
                   metavar="HxW|1080p|4k", help="shape to warm (repeatable)")
    p.add_argument("--images", help="warm every distinct shape in this "
                                    "directory (headers only)")
    p.add_argument("--effect", action="append", default=[],
                   choices=["b", "g", "h"],
                   help="also warm the fused solve+effect programs "
                        "(repeatable)")
    p.add_argument("--incremental", type=int, default=0, metavar="N",
                   help="also warm the windowed live re-solve (budget N)")
    p.add_argument("--jobs", type=int, default=6,
                   help="concurrent compiles (default 6)")
    # Solver-surface flags, resolved exactly like rtdd-serve's.
    p.add_argument("--backend", default="auto")
    p.add_argument("--profile", choices=["faithful", "fast"], default=None)
    p.add_argument("--solver", default=None,
                   choices=["jacobi_chebyshev", "jacobi", "red_black"])
    p.add_argument("--multigrid", choices=["cascadic", "vcycle"], default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--early-exit", action="store_true")
    p.add_argument("--tolerance", type=float, default=None)
    p.add_argument("--residual-metric", default=None, choices=["rms", "max"])
    p.add_argument("--rb-rho", type=float, default=None)
    p.add_argument("--rb-plain", action="store_true")
    p.add_argument("--defocus-quality", choices=["auto", "exact", "approx"],
                   default=None)
    p.add_argument("--defocus-stride", type=int, default=None, metavar="N")
    a = p.parse_args(argv)

    shapes = list(a.size)
    if a.images:
        for s in shapes_from_images(a.images):
            if s not in shapes:
                shapes.append(s)
    if not shapes:
        print("no shapes to warm (pass --size and/or --images)",
              file=sys.stderr)
        return 2

    import dataclasses

    cfg = config_from_args(a, p.error)
    if a.incremental > 0:
        cfg = dataclasses.replace(
            cfg, incremental_iterations=max(int(a.incremental), 0)
        )

    from .utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    print(f"persistent cache: {cache or 'DISABLED'}")
    effects = [
        {"b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION,
         "h": fx.EFFECT_HAZE}[e]
        for e in dict.fromkeys(a.effect)
    ]
    t0 = time.perf_counter()
    for h, w in shapes:
        dt = warm_shape(h, w, cfg, effects, a.incremental > 0, a.jobs)
        print(f"{h}x{w}: warmed in {dt:.1f} s")
    print(f"total: {len(shapes)} shape(s) in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
