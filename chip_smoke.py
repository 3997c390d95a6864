"""On-card smoke test: the main path, run once on an NVIDIA GPU and checked.

    python chip_smoke.py                # one card: phases d, a, b, c, e
    python chip_smoke.py --four-cards   # the four-card mesh path (f) only

Phases:
  d  the ``gpu``-marked pytest tests, in a child process that runs and exits
     before this process first touches the card (one process per card);
  a  library at full size: get_pipeline -> prepare_image -> solve_and_effect
     on the seeded synthetic pair (tests/golden/synthetic.py) at 1080x1920
     and a 2x2 upscale to 2160x3840; depth vs oracle/numpy_ref.solve_pyramid
     (RMSE <= 1e-3 on depth normalized to [0,1]) and exact defocus, haze and
     desaturation vs numpy_ref on the same depth (u8 max abs diff <= 1);
  b  a live DepthSession at 1080p: a full solve, then three brush strokes on
     the windowed incremental path, each within RMSE 3e-2 of a full re-solve;
  c  the CLI (headless solve + effect, saved PNGs) and rtdd-serve over a
     directory of 3 pairs with --report, in-process; outputs match phase a;
  e  the 1080p frame's compile time and memory_analysis(), and the frame and
     the coarse level timed with and without the coarse-level kernel, in
     turns (XLA, kernel, kernel, XLA);
  f  (--four-cards) parallel.batched_step on a (1,2,2) mesh of 4 GPUs at
     1080x1920 vs the single-card depth, then rtdd-serve --multichip
     --batch 4 on 4 pairs.

Every line names the card; the last line is one JSON object
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Nothing falls back to the CPU or to interpret mode. Scratch files go to
build/chip_smoke/ (git-ignored) and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests", "golden")]

CARD = ""


def say(*a) -> None:
    print(f"[{CARD}]", *a, flush=True)


def check(ok: bool, what: str) -> None:
    say(("ok   " if ok else "FAIL ") + what)
    if not ok:
        raise SystemExit(1)


def quoted(fn, *args):
    """fn(*args) with its stdout re-printed line by line under the card's
    name (the CLI and rtdd-serve print progress of their own)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    for line in buf.getvalue().splitlines():
        say(" ", line)
    return out


def nrmse(a, b) -> float:
    import numpy as np

    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) / 255.0
    return float(np.sqrt(np.mean(d * d)))


def phase_d_gpu_tests() -> None:
    """The gpu-marked tests, in a child, before this process uses the card."""
    with tempfile.TemporaryDirectory(dir=scratch()) as d:
        xml = os.path.join(d, "gpu.xml")
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu",
             "-q", "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        for line in r.stdout.strip().splitlines()[-5:]:
            say("pytest:", line)
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors", "skipped")}
    check(r.returncode == 0 and n["tests"] > 0 and n["failures"] == n["errors"]
          == n["skipped"] == 0, f"d: gpu-marked tests on the card {n}")


def scratch() -> str:
    d = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(d, exist_ok=True)
    return d


def phase_a_library(results: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import synthetic_frame
    from realtimedepthdiffusion import get_pipeline
    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.oracle import numpy_ref as ref

    exact = DiffusionConfig(pallas_defocus_quality="exact")
    effect = jax.jit(
        lambda e, rgb, gray, d: fx.apply_effect(e, rgb, gray, d, exact),
        static_argnums=0,
    )
    for size in ("1080p", "4k"):
        rgb, mask, value = synthetic_frame(size)
        h, w = mask.shape
        t0 = time.perf_counter()
        pipe = get_pipeline(h, w)
        rgb_d, gpyr = pipe.prepare_image(rgb)
        depth, _, art = pipe.solve_and_effect(
            fx.EFFECT_DEFOCUS, gpyr, rgb_d, jnp.asarray(mask), jnp.asarray(value),
            pipe.initial_state(),
        )
        depth, art = np.asarray(depth), np.asarray(art)
        say(f"a: {h}x{w} first solve+defocus (compile included) "
            f"{time.perf_counter() - t0:.2f} s")
        check(depth.shape == (h, w) and np.isfinite(depth).all()
              and art.shape == (h, w, 3) and art.dtype == np.uint8,
              f"a: {h}x{w} depth finite {depth.shape}, effect {art.shape} {art.dtype}")
        check(np.array_equal(depth[mask], value[mask].astype(np.float32)),
              f"a: {h}x{w} scribbles pinned")

        gray = ref.rgb_to_gray(rgb)
        t0 = time.perf_counter()
        want, _ = ref.solve_pyramid(gray, mask, value, None, DiffusionConfig())
        err = nrmse(depth, want)
        check(err <= 1e-3,
              f"a: {h}x{w} depth vs numpy_ref: RMSE {err:.3e} <= 1e-3, max abs "
              f"{np.abs(depth - want).max():.4f} gray levels (oracle "
              f"{time.perf_counter() - t0:.1f} s)")

        d = np.clip(depth, 0.0, 255.0).astype(np.float32)
        d_dev = jnp.asarray(d)
        refs = {
            "defocus": (fx.EFFECT_DEFOCUS, lambda: ref.defocus(rgb, d, exact)),
            "haze": (fx.EFFECT_HAZE, lambda: ref.haze(rgb, d, exact)),
            "desaturation": (fx.EFFECT_DESATURATION,
                             lambda: ref.desaturation(rgb, gray, d)),
        }
        for name, (e, want_fn) in refs.items():
            got = np.asarray(effect(e, rgb_d, gpyr[0], d_dev)).astype(np.int32)
            diff = int(np.abs(got - want_fn().astype(np.int32)).max())
            check(diff <= 1, f"a: {h}x{w} exact {name} vs numpy_ref: u8 max "
                             f"abs diff {diff} <= 1")
        if size == "1080p":
            got = np.asarray(effect(fx.EFFECT_DEFOCUS, rgb_d, gpyr[0], d_dev))
            check(np.array_equal(got, art),
                  "a: 1080p user-path defocus == exact defocus (auto resolves exact)")
            results["depth_1080"] = depth
            results["frame_1080"] = (rgb, mask, value)


def phase_b_session(results: dict) -> None:
    import jax.numpy as jnp
    import numpy as np

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, mask, value = results["frame_1080"]
    h, w = mask.shape
    cfg = DiffusionConfig(incremental_iterations=120, fast_start=False)
    sess = DepthSession(rgb, cfg)
    np.copyto(sess.mask_np, mask.astype(np.uint8))
    np.copyto(sess.value_np, value)
    # A user's scribble layer over the pair's own sparse blobs: a 5 x 7 grid
    # of short strokes (5 brush dabs, 50 px apart), far (key 4) at the top
    # to near (key 0) at the bottom — about 4% coverage, the density of hand
    # scribbles. On the blobs alone (0.3%) a full warm re-solve itself moves
    # this content by 1-3% RMSE, so no local update can stay near it
    # (PERF.md).
    rows, cols, dabs = 5, 7, 5
    ends = {}
    for r in range(rows):
        for c in range(cols):
            sess.set_color_key((rows - 1 - r) * 5 // rows)
            y, x0 = int((r + 0.5) * h / rows), int((c + 0.3) * w / cols)
            for p in range(dabs):
                sess.paint(x0 + 50 * p, y)
            ends[r, c] = ((rows - 1 - r) * 5 // rows, x0 + 50 * dabs, y)
    t0 = time.perf_counter()
    sess.solve()
    say(f"b: session first full solve {time.perf_counter() - t0:.2f} s "
        f"({sess.mask_np.mean() * 100:.1f}% annotated)")
    local = []
    real = sess.pipe.solve_incremental
    sess.pipe.solve_incremental = lambda *a: local.append(1) or real(*a)
    # Three strokes, each extending a scribble with its own color key.
    for i, rc in enumerate([(1, 1), (2, 3), (3, 5)]):
        key, x, y = ends[rc]
        prev = tuple(jnp.array(s) for s in sess.depth_state)
        n_local = len(local)
        sess.set_color_key(key)
        sess.paint(x, y)
        t0 = time.perf_counter()
        sess.solve()
        dt = time.perf_counter() - t0
        d_full, _ = sess.pipe.solve(
            sess.gray_pyr, jnp.asarray(sess.mask_np.astype(bool)),
            jnp.asarray(sess.value_np), prev,
        )
        err = nrmse(sess.depth0, d_full)
        check(len(local) > n_local and err <= 3e-2,
              f"b: stroke {i + 1} on the windowed incremental path "
              f"({dt * 1e3:.1f} ms incl. first-call compile), RMSE vs full "
              f"re-solve {err:.3e} <= 3e-2")


def phase_c_cli_and_serve(results: dict) -> None:
    import numpy as np

    from realtimedepthdiffusion.io import depth_to_u8, imread_gray, imwrite
    from realtimedepthdiffusion.live.cli import main as cli_main
    from realtimedepthdiffusion.serve import main as serve_main

    rgb, mask, value = results["frame_1080"]
    want = depth_to_u8(results["depth_1080"]).astype(np.int32)
    ann = np.where(mask, value, 32).astype(np.uint8)
    with tempfile.TemporaryDirectory(dir=scratch()) as d:
        img_p, ann_p = os.path.join(d, "pair.png"), os.path.join(d, "pair_ann.png")
        imwrite(img_p, rgb)
        imwrite(ann_p, ann)
        out = os.path.join(d, "cli")
        rc = quoted(cli_main, ["-i", img_p, "-a", ann_p, "--headless",
                               "--solve", "--effect", "b", "--save-dir", out])
        names = ("AnnotatedImage.png", "DepthMap.png", "ArtisticEffect.png")
        check(rc == 0 and all(os.path.exists(os.path.join(out, f)) for f in names),
              f"c: CLI headless solve+refocus wrote {', '.join(names)}")
        diff = int(np.abs(imread_gray(os.path.join(out, "DepthMap.png")) - want).max())
        check(diff <= 1, f"c: CLI DepthMap.png vs phase a depth: max diff {diff} <= 1")

        imgs, anns, srv = (os.path.join(d, n) for n in ("images", "anns", "serve"))
        os.makedirs(imgs)
        os.makedirs(anns)
        for stem in "abc":
            imwrite(os.path.join(imgs, f"{stem}.png"), rgb)
            imwrite(os.path.join(anns, f"{stem}.png"), ann)
        report = os.path.join(d, "report.json")
        rc = quoted(serve_main, ["--images", imgs, "--annotations", anns,
                                 "--out", srv, "--effect", "h", "--report", report])
        with open(report) as f:
            counts = json.load(f)["counts"]
        check(rc == 0 and counts["solved"] == 3 and counts["failed"] == 0,
              f"c: rtdd-serve solved 3 pairs with --report {counts}")
        for stem in "abc":
            got = imread_gray(os.path.join(srv, f"{stem}_depth.png"))
            diff = int(np.abs(got.astype(np.int32) - want).max())
            check(diff <= 1 and os.path.exists(os.path.join(srv, f"{stem}_effect.png")),
                  f"c: serve {stem}_depth.png vs phase a depth: max diff "
                  f"{diff} <= 1; {stem}_effect.png written")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2"))
    check(not bad, f"c: library path imported neither PIL nor cv2 {bad}")


def timed(fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_e_compile_and_timing(results: dict, frames: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.ops import coarse_sweep, dispatch
    from realtimedepthdiffusion.pipeline import DepthPipeline

    rgb, mask, value = results["frame_1080"]
    h, w = mask.shape
    runs, depths = {}, {}
    # backend "pallas" raises where the platform has no kernel: the kernel
    # side can never silently run on XLA.
    for route, backend in (("xla", "xla"), ("kernel", "pallas")):
        cfg = DiffusionConfig(backend=backend, fast_start=False)
        pipe = DepthPipeline(h, w, cfg)
        rgb_d, gpyr = pipe.prepare_image(rgb)
        m, v = jnp.asarray(mask), jnp.asarray(value)
        t0 = time.perf_counter()
        lowered = pipe._solve_and_effect.lower(
            fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, pipe.initial_state())
        t1 = time.perf_counter()
        compiled = lowered.compile()
        t2 = time.perf_counter()
        ma = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes", "temp_size_in_bytes",
                  "generated_code_size_in_bytes")
        mem = {f: getattr(ma, f, None) for f in fields}
        say(f"e: 1080p solve+defocus frame [{route}] trace+lower {t1 - t0:.2f} s, "
            f"compile {t2 - t1:.2f} s; memory_analysis {mem}")
        state = [pipe.initial_state()]

        def frame(compiled=compiled, gpyr=gpyr, rgb_d=rgb_d, m=m, v=v, state=state):
            d, state[0], out = compiled(gpyr, rgb_d, m, v, state[0])
            jax.block_until_ready((d, state[0], out))
            return d

        depths[route] = np.asarray(frame())
        runs[route] = frame
    err = nrmse(depths["kernel"], depths["xla"])
    check(err <= 1e-3, f"e: frame depth kernel vs XLA: RMSE {err:.3e}, max abs "
                       f"{np.abs(depths['kernel'] - depths['xla']).max():.4f}")
    for route in ("xla", "kernel", "kernel", "xla"):
        t = timed(runs[route], frames)
        say(f"e: 1080p solve+defocus frame [{route}] median "
            f"{statistics.median(t):.3f} ms, min {min(t):.3f} ms over {len(t)}")

    # Where the frame's time goes: each level's sweeps alone (weights
    # included), on XLA and — where the level fits one CTA — the kernel,
    # in turns; then the defocus effect alone.
    cfg = DiffusionConfig()
    levels = cfg.num_levels(h, w)
    for level in range(levels - 1, -1, -1):
        lh, lw = cfg.level_size(h, w, level)
        iters = cfg.level_iterations(levels, level)
        rng = np.random.default_rng(level)
        g = jnp.asarray(rng.integers(0, 256, (lh, lw), dtype=np.uint8))
        mk = jnp.asarray(rng.random((lh, lw)) < 0.02)
        d0 = jnp.where(mk, 64.0, 255.0).astype(jnp.float32)
        routes = [("xla", "xla")]
        if coarse_sweep.fits(lh, lw):
            routes.append(("kernel", "pallas"))
        fns = {}
        for route, backend in routes:
            c = DiffusionConfig(backend=backend)
            fns[route] = jax.jit(lambda d, m, g, c=c: dispatch.solve_level(
                d, m, g, level, levels - 1, iters, c))
        outs = {r: np.asarray(f(d0, mk, g)) for r, f in fns.items()}
        if "kernel" in outs:
            err = nrmse(outs["kernel"], outs["xla"])
            check(err <= 1e-4, f"e: level {level} ({lh}x{lw}) kernel vs XLA: "
                               f"RMSE {err:.2e} <= 1e-4, max abs "
                               f"{np.abs(outs['kernel'] - outs['xla']).max():.2e}")
        turns = ("xla", "kernel", "kernel", "xla") if "kernel" in fns else ("xla",)
        for route in turns:
            t = timed(lambda f=fns[route]: f(d0, mk, g).block_until_ready(), frames)
            warps = (f", {coarse_sweep.num_warps(lh, lw)} warps"
                     if route == "kernel" else "")
            say(f"e: level {level} ({lh}x{lw}, {iters} sweeps{warps}) [{route}] "
                f"median {statistics.median(t):.3f} ms, min {min(t):.3f} ms")

    from bench import synthetic_frame

    for size, quality in (("1080p", "exact"), ("4k", "exact"), ("4k", "auto")):
        rgb_s, mask_s, _ = synthetic_frame(size)
        c = DiffusionConfig(pallas_defocus_quality=quality)
        f = jax.jit(lambda r, d, c=c: fx.defocus(r, d, c))
        r_d = jnp.asarray(rgb_s)
        d_d = jnp.asarray(np.where(mask_s, 254.0, 128.0).astype(np.float32))
        f(r_d, d_d).block_until_ready()
        t = timed(lambda: f(r_d, d_d).block_until_ready(), frames)
        say(f"e: defocus alone {mask_s.shape[0]}x{mask_s.shape[1]} [{quality}] "
            f"median {statistics.median(t):.3f} ms, min {min(t):.3f} ms")


def phase_f_four_cards() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import synthetic_frame
    from realtimedepthdiffusion import get_pipeline
    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.core.multigrid import initial_depth_state
    from realtimedepthdiffusion.io import depth_to_u8, imread_gray, imwrite
    from realtimedepthdiffusion.parallel.mesh import make_mesh
    from realtimedepthdiffusion.parallel.sharded import batched_step
    from realtimedepthdiffusion.serve import main as serve_main

    rgb, mask, value = synthetic_frame("1080p")
    h, w = mask.shape
    cfg = DiffusionConfig()
    pipe = get_pipeline(h, w)
    _, gpyr = pipe.prepare_image(rgb)
    single, _ = pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value),
                           pipe.initial_state())
    single = np.asarray(single)

    mesh = make_mesh(4)
    check(tuple(mesh.devices.shape) == (1, 2, 2),
          f"f: mesh {dict(mesh.shape)} over {mesh.devices.size} "
          f"{mesh.devices.flat[0].platform} devices")
    fn, _ = batched_step(mesh, h, w, cfg, effect=fx.EFFECT_HAZE)
    state = tuple(np.asarray(s)[None] for s in initial_depth_state(h, w, cfg))
    args = (rgb[None], mask[None], value[None], state)
    t0 = time.perf_counter()
    step = fn.lower(*args).compile()
    placed = jax.device_put(args, step.input_shardings[0])
    depth, _, out = step(*placed)
    depth = np.asarray(depth)[0]
    say(f"f: batched_step {h}x{w} compile + first step "
        f"{time.perf_counter() - t0:.2f} s")
    times = timed(lambda: jax.block_until_ready(step(*placed)), 10)
    say(f"f: batched_step {h}x{w} on {mesh.devices.size} devices median "
        f"{statistics.median(times):.3f} ms over {len(times)}")
    err = nrmse(depth, single)
    check(err <= 1e-3 and np.asarray(out).shape == (1, h, w, 3),
          f"f: sharded depth vs single-card depth: RMSE {err:.3e} <= 1e-3")

    want = depth_to_u8(single).astype(np.int32)
    ann = np.where(mask, value, 32).astype(np.uint8)
    with tempfile.TemporaryDirectory(dir=scratch()) as d:
        imgs, anns, srv = (os.path.join(d, n) for n in ("images", "anns", "serve"))
        os.makedirs(imgs)
        os.makedirs(anns)
        for stem in "abcd":
            imwrite(os.path.join(imgs, f"{stem}.png"), rgb)
            imwrite(os.path.join(anns, f"{stem}.png"), ann)
        report = os.path.join(d, "report.json")
        rc = quoted(serve_main, ["--images", imgs, "--annotations", anns,
                                 "--out", srv, "--multichip", "--batch", "4",
                                 "--report", report])
        with open(report) as f:
            counts = json.load(f)["counts"]
        check(rc == 0 and counts["solved"] == 4,
              f"f: rtdd-serve --multichip --batch 4 answered {counts}")
        for stem in "abcd":
            got = imread_gray(os.path.join(srv, f"{stem}_depth.png"))
            err = nrmse(got, want)
            check(err <= 1e-3, f"f: serve {stem}_depth.png vs single-card "
                               f"depth: RMSE {err:.3e} <= 1e-3")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path (phase f)")
    ap.add_argument("--frames", type=int, default=20,
                    help="timed runs per turn in phase e")
    args = ap.parse_args(argv)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    CARD = smi[0]
    for line in smi:
        print(line, flush=True)

    import realtimedepthdiffusion  # noqa: F401 — fails outside a checkout

    t_start = time.perf_counter()
    if not args.four_cards:
        phase_d_gpu_tests()

    from realtimedepthdiffusion.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    import jax

    devs = jax.devices()
    want = 4 if args.four_cards else 1
    check(all(d.platform == "gpu" for d in devs) and len(devs) >= want,
          f"JAX sees {len(devs)} x {devs[0].device_kind} ({devs[0].platform}); "
          f"compile cache {cache}")
    results: dict = {}
    try:
        if args.four_cards:
            phase_f_four_cards()
        else:
            phase_a_library(results)
            phase_b_session(results)
            phase_c_cli_and_serve(results)
            phase_e_compile_and_timing(results, args.frames)
    finally:
        shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
