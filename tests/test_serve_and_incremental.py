"""Batch serving + incremental live-solve tests."""

import os
import time

import pytest

import numpy as np
import jax.numpy as jnp

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.io import imread_gray, imwrite, save_annotation
from realtimedepthdiffusion.live.session import DepthSession
from realtimedepthdiffusion.serve import discover_pairs, main as serve_main
from tests.conftest import synthetic_pair


def _write_pair(d, name, h, w, seed):
    rgb, mask, value = synthetic_pair(h, w, seed)
    imwrite(os.path.join(d, "images", f"{name}.png"), rgb)
    save_annotation(os.path.join(d, "annotations", f"{name}.png"), mask, value)
    return rgb, mask, value


def test_serve_directory_mode(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    _write_pair(d, "b", 64, 80, 2)  # same shape: pipeline reused
    _write_pair(d, "c", 72, 96, 3)  # new shape: second pipeline
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    assert len(pairs) == 3

    out = os.path.join(d, "out")
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", out, "--effect", "h", "--backend", "xla",
    ])
    assert rc == 0
    for name in ("a", "b", "c"):
        assert os.path.exists(os.path.join(out, f"{name}_depth.png"))
        assert os.path.exists(os.path.join(out, f"{name}_effect.png"))
    # depth respects a scribble
    _, mask, value = synthetic_pair(64, 80, 1)
    dm = imread_gray(os.path.join(out, "a_depth.png"))
    ys, xs = np.nonzero(mask)
    assert abs(int(dm[ys[0], xs[0]]) - int(value[ys[0], xs[0]])) <= 1


def test_serve_requires_input(capsys):
    assert serve_main(["--out", "/tmp/x"]) == 2


def _watch_args(d, *extra):
    return [
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "out"), "--backend", "xla",
        "--watch", "--poll-interval", "0.1", *extra,
    ]


def test_serve_watch_new_and_updated_pairs(tmp_path):
    """--watch: a pair dropped in AFTER the initial scan is picked up, an
    annotation rewritten on disk re-solves its pair, and the service exits 0
    via --idle-exit. The manifest covers every pair ever seen."""
    import json
    import threading

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")
    depth_a1 = {}

    def later():
        # Wait for a's first solve, snapshot it, then drop a NEW pair and
        # rewrite a's annotation (different scribble -> different depth).
        deadline = time.time() + 30
        p = os.path.join(out, "a_depth.png")
        while not os.path.exists(p) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)  # let the write settle past the poll in flight
        depth_a1["v"] = imread_gray(p).copy()
        _write_pair(d, "b", 64, 80, 2)  # same shape: pipeline reuse
        # synthetic_pair's scribbles are seed-independent; invert the
        # depths so the rewritten annotation genuinely changes the solve.
        _rgb, mask, value = synthetic_pair(64, 80, 1)
        save_annotation(
            os.path.join(d, "annotations", "a.png"),
            mask, np.where(mask, 254 - value, 0).astype(np.uint8),
        )

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(
        d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")
    ))
    t.join()
    assert rc == 0
    assert os.path.exists(os.path.join(out, "b_depth.png"))
    # a was re-solved against the rewritten annotation
    depth_a2 = imread_gray(os.path.join(out, "a_depth.png"))
    assert not np.array_equal(depth_a1["v"], depth_a2)
    rep = json.load(open(os.path.join(d, "rep.json")))
    by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
    assert by["a.png"]["status"] == "solved"
    assert by["b.png"]["status"] == "solved"
    assert rep["counts"]["total"] == 2


def test_serve_watch_reuses_pipelines_and_gives_up_on_bad_file(
    tmp_path, monkeypatch
):
    """--watch keeps per-shape pipelines resident across batches (one
    DepthPipeline for two same-shape batches) and a pair whose decode keeps
    failing is retried then recorded 'failed' without killing the service
    (exit code 1 flags it)."""
    import json
    import threading

    import realtimedepthdiffusion.pipeline as pipeline_mod

    built = []
    real = pipeline_mod.DepthPipeline

    class Spy(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append((args[0], args[1]))

    monkeypatch.setattr(pipeline_mod, "DepthPipeline", Spy)

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    # A pair whose image is not decodable at all (and never changes):
    with open(os.path.join(d, "images", "bad.png"), "wb") as f:
        f.write(b"not a png")
    with open(os.path.join(d, "annotations", "bad.png"), "wb") as f:
        f.write(b"not a png")
    out = os.path.join(d, "out")

    def later():
        deadline = time.time() + 30
        p = os.path.join(out, "a_depth.png")
        while not os.path.exists(p) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        _write_pair(d, "c", 64, 80, 3)  # same shape, second batch

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(
        d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")
    ))
    t.join()
    assert rc == 1  # the given-up bad pair is flagged
    assert os.path.exists(os.path.join(out, "a_depth.png"))
    assert os.path.exists(os.path.join(out, "c_depth.png"))
    assert built.count((64, 80)) == 1  # resident across batches
    rep = json.load(open(os.path.join(d, "rep.json")))
    by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
    assert by["bad.png"]["status"] == "failed"
    assert by["a.png"]["status"] == "solved"
    assert by["c.png"]["status"] == "solved"


def test_serve_watch_gave_up_pair_not_reported_solved(tmp_path):
    """The --watch manifest reports the LATEST status: a pair that solved
    once and was then overwritten with an undecodable file must end
    'failed' in the manifest when the service gives up on its current
    contents — not stay 'solved' with the stale depth path while the
    service exits 1 (pre-fix, a consumer saw every pair solved yet a
    failing exit code, and never learned which pair was broken)."""
    import json
    import threading

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")

    def later():
        deadline = time.time() + 30
        p = os.path.join(out, "a_depth.png")
        while not os.path.exists(p) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        # Overwrite the solved image with garbage (new mtime signature).
        with open(os.path.join(d, "images", "a.png"), "wb") as f:
            f.write(b"not a png")

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(
        d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")
    ))
    t.join()
    assert rc == 1  # the given-up pair flags the exit
    rep = json.load(open(os.path.join(d, "rep.json")))
    by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
    assert by["a.png"]["status"] == "failed", by["a.png"]
    assert by["a.png"]["depth"] is None
    assert rep["counts"]["failed"] == 1


def test_trim_pipelines_lru():
    """_trim_pipelines evicts least-recently-USED-first and solve_pairs
    records a use (move_to_end) when it reuses a resident shape."""
    from collections import OrderedDict

    from realtimedepthdiffusion.serve import _trim_pipelines

    pipes = OrderedDict([((1, 1), "a"), ((2, 2), "b"), ((3, 3), "c")])
    pipes.move_to_end((1, 1))  # (1,1) most recently used
    assert _trim_pipelines(pipes, 2) == [(2, 2)]
    assert list(pipes) == [(3, 3), (1, 1)]
    assert _trim_pipelines(pipes, 8) == []  # under cap: no-op
    # cap is floored at 1: never evict the last resident shape
    assert _trim_pipelines(pipes, 0) == [(3, 3)]
    assert list(pipes) == [(1, 1)]


def test_serve_watch_max_shapes_evicts_and_recompiles(tmp_path, monkeypatch):
    """--watch --max-shapes 1: a second image shape evicts the first's
    resident pipeline after its batch; when the first shape is seen again a
    NEW pipeline is built (the LRU bound is real, and eviction is safe)."""
    import threading

    import realtimedepthdiffusion.pipeline as pipeline_mod

    built = []
    real = pipeline_mod.DepthPipeline

    class Spy(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append((args[0], args[1]))

    monkeypatch.setattr(pipeline_mod, "DepthPipeline", Spy)

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")

    def later():
        deadline = time.time() + 30
        p = os.path.join(out, "a_depth.png")
        while not os.path.exists(p) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        _write_pair(d, "b", 72, 96, 2)  # new shape: evicts (64, 80)
        deadline = time.time() + 30
        p = os.path.join(out, "b_depth.png")
        while not os.path.exists(p) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        _write_pair(d, "c", 64, 80, 3)  # first shape again: rebuilt

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--max-shapes", "1"))
    t.join()
    assert rc == 0
    for name in ("a", "b", "c"):
        assert os.path.exists(os.path.join(out, f"{name}_depth.png"))
    assert built.count((64, 80)) == 2  # evicted by (72, 96), then rebuilt
    assert built.count((72, 96)) == 1


@pytest.mark.slow
def test_serve_watch_shared_stem_settles(tmp_path, capsys):
    """--watch: two images sharing a stem (a.jpg + a.png, both matching
    annotation a.png) are distinct pairs with distinct mtime signatures.
    Keying the settled-signature bookkeeping by stem made their signatures
    evict each other, re-solving the pair on every scan forever; keyed by
    image path, each solves once and the service goes idle (regression)."""
    import threading

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    rgb, _m, _v = _write_pair(d, "a", 64, 80, 1)
    # Second image with the SAME stem, different extension + mtime.
    imwrite(os.path.join(d, "images", "a.jpg"), rgb)
    os.utime(os.path.join(d, "images", "a.jpg"),
             (time.time() - 10, time.time() - 10))

    done = {}

    def run():
        done["rc"] = serve_main(_watch_args(d, "--idle-exit", "1.0"))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    # With stem-keyed signatures the service never idles (every scan finds
    # the pair "changed" again) and this join times out.
    assert not t.is_alive(), "watch service kept re-solving a settled pair"
    assert done["rc"] == 0
    assert os.path.exists(os.path.join(d, "out", "a_depth.png"))
    # Each image solved exactly once: one progress line per input pair.
    lines = [l for l in capsys.readouterr().out.splitlines() if " -> " in l]
    assert len(lines) == 2


@pytest.mark.slow
def test_serve_watch_sigterm_writes_manifest(tmp_path):
    """--watch: SIGTERM (the service-manager stop signal) exits through the
    Ctrl-C path — final manifest written, exit code 0 — instead of dying
    with the default handler and no report."""
    import json
    import signal
    import subprocess
    import sys

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")
    rep = os.path.join(d, "rep.json")

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "realtimedepthdiffusion.serve",
         "--images", os.path.join(d, "images"),
         "--annotations", os.path.join(d, "annotations"),
         "--out", out, "--backend", "xla", "--watch",
         "--poll-interval", "0.2", "--report", rep],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        deadline = time.time() + 120
        while not os.path.exists(os.path.join(out, "a_depth.png")):
            assert time.time() < deadline, "first solve never landed"
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        time.sleep(0.5)  # let the post-batch manifest write settle
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (proc.returncode, stderr[-2000:])
    assert "interrupted, exiting" in stderr
    data = json.load(open(rep))
    assert data["pairs"][0]["status"] == "solved"


def test_serve_watch_flag_validation(capsys):
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch"])  # needs directories
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch", "--images", "i",
                    "--annotations", "a", "--multichip"])
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch", "--images", "i",
                    "--annotations", "a", "--poll-interval", "0"])
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch", "--images", "i",
                    "--annotations", "a", "--max-shapes", "0"])
    # --png-level must validate BEFORE the watch loop starts: an invalid
    # level would otherwise only surface as a per-write zlib error inside
    # the writer pool — the service would run, retry, and give up on every
    # pair while producing zero outputs.
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch", "--images", "i",
                    "--annotations", "a", "--png-level", "12"])


def test_serve_never_kicks_background_compiles(tmp_path, monkeypatch):
    """Batch serving must not start background fused compiles: the staged
    path is bit-identical, and an in-flight XLA compile cannot be cancelled
    — it would block process exit for its full duration
    (pipeline._join_background_compiles)."""
    import realtimedepthdiffusion.serve as serve_mod

    monkeypatch.setenv("RTDD_FAST_START", "1")
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)

    captured = []
    from realtimedepthdiffusion.pipeline import DepthPipeline as real

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    import realtimedepthdiffusion.pipeline as pipeline_mod

    monkeypatch.setattr(pipeline_mod, "DepthPipeline", Spy)
    rc = serve_mod.main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "out"), "--backend", "xla",
    ])
    assert rc == 0
    (p,) = captured
    assert p.cfg.fast_start  # staging itself stays on
    assert p.background_compile is False
    assert not p._compile_threads  # nothing was kicked


def test_serve_png_level_same_pixels_smaller_effort(tmp_path):
    """--png-level changes only the PNG zlib effort: pixel content must be
    identical to the default-level run (PNG is lossless at every level), and
    an out-of-range level is rejected at the CLI."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    args = [
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--effect", "h", "--backend", "xla",
    ]
    assert serve_main(args + ["--out", os.path.join(d, "o6")]) == 0
    assert serve_main(
        args + ["--out", os.path.join(d, "o1"), "--png-level", "1"]
    ) == 0
    for suffix in ("depth", "effect"):
        ref = imread_gray(os.path.join(d, "o6", f"a_{suffix}.png"))
        fast = imread_gray(os.path.join(d, "o1", f"a_{suffix}.png"))
        np.testing.assert_array_equal(ref, fast)

    with pytest.raises(SystemExit):
        serve_main(args + ["--out", os.path.join(d, "bad"),
                           "--png-level", "11"])


def test_serve_profile_fast_config_resolution():
    """--profile fast resolves to the framework's fastest measured solver
    configuration (red_black + RMS early exit @1e-3, PERF.md round-3);
    explicit flags override the profile; invalid combinations exit loudly."""
    import contextlib
    import io

    import realtimedepthdiffusion.serve as serve_mod

    def parse(extra):
        """Run main() through argument parsing + config resolution only
        (no input pairs -> it returns 2 right after building the config),
        capturing the DiffusionConfig it resolved. Flag errors propagate
        as the parser's SystemExit."""
        holder = {}
        real = serve_mod.config_from_args

        def capture(a, error=None):
            holder["cfg"] = real(a, error)
            return holder["cfg"]

        serve_mod.config_from_args = capture
        try:
            with contextlib.redirect_stderr(io.StringIO()), \
                 contextlib.redirect_stdout(io.StringIO()):
                serve_mod.main(["--out", "/tmp/x"] + extra)
        finally:
            serve_mod.config_from_args = real
        return holder["cfg"]

    cfg = parse(["--profile", "fast"])
    assert cfg.solver == "red_black" and cfg.early_exit
    assert cfg.tolerance == 1e-3 and cfg.residual_metric == "rms"

    cfg = parse(["--profile", "faithful"])
    assert cfg.solver == "jacobi_chebyshev" and not cfg.early_exit
    assert cfg == DiffusionConfig()  # today's defaults, exactly

    # explicit flags override the profile; the early exit survives a solver
    # override because every solver honors the tolerance now (round 5)
    cfg = parse(["--profile", "fast", "--solver", "jacobi_chebyshev"])
    assert cfg.solver == "jacobi_chebyshev" and cfg.early_exit
    cfg = parse(["--profile", "fast", "--tolerance", "1e-4",
                 "--residual-metric", "max", "--rb-plain"])
    assert cfg.tolerance == 1e-4 and cfg.residual_metric == "max"
    assert not cfg.rb_chebyshev

    # --early-exit alone now rides the default (reference) solver
    cfg = parse(["--early-exit"])
    assert cfg.solver == "jacobi_chebyshev" and cfg.early_exit


def test_serve_profile_fast_takes_early_exit_path(tmp_path, monkeypatch):
    """rtdd-serve --profile fast must actually ROUTE through the red-black
    early-exit solver (the round-3 verdict's gap: the fastest measured
    configuration was unreachable from the serving surface)."""
    from realtimedepthdiffusion.core import solver as core_solver

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)

    calls = []
    real = core_solver.solve_red_black

    def spy(depth, mask, wts, iters, cfg=DiffusionConfig(), early_exit=None):
        calls.append(cfg.early_exit if early_exit is None else early_exit)
        return real(depth, mask, wts, iters, cfg, early_exit)

    monkeypatch.setitem(core_solver._SOLVERS, "red_black", spy)
    out = os.path.join(d, "out")
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", out, "--backend", "xla", "--profile", "fast",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "a_depth.png"))
    assert calls and all(calls), (
        "profile fast did not route every level through the early-exit "
        f"red-black solver: {calls}"
    )


def test_incremental_solve_converges_to_full():
    """With incremental_iterations set, warm re-solves after a small edit
    stay close to a full-budget solve."""
    rgb, mask, value = synthetic_pair(80, 96, 9)
    full = DepthSession(rgb, DiffusionConfig(max_iterations=300))
    inc = DepthSession(
        rgb, DiffusionConfig(max_iterations=300, incremental_iterations=60)
    )
    for s in (full, inc):
        s.mask_np[:] = mask
        s.value_np[:] = value
        s.solve()  # first solve: full budget in both sessions

    # small edit + re-solve
    for s in (full, inc):
        s.set_color_key(2)
        s.paint(48, 40)
        d = s.solve()
    d_full = full.depth_image().astype(np.float32)
    d_inc = inc.depth_image().astype(np.float32)
    assert inc.solve_count == 2
    rmse = float(np.sqrt(np.mean(((d_full - d_inc) / 255.0) ** 2)))
    assert rmse < 3e-2, rmse  # visually near-indistinguishable
    assert d_inc[40, 48] == 128.0  # new scribble pinned


def test_residual_report():
    rgb, mask, value = synthetic_pair(80, 96, 4)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=200))
    s.mask_np[:] = mask
    s.value_np[:] = value
    s.solve()
    rep = s.residual_report()
    assert "L0=max" in rep and "/rms" in rep
    # both norms are small after a full solve, and rms <= max per level
    import re

    pairs = re.findall(r"max ([0-9.]+)/rms ([0-9.]+)", rep)
    assert pairs
    for mx, rm in pairs:
        assert float(rm) <= float(mx) < 5.0


def test_session_checkpoint_roundtrip(tmp_path):
    rgb, mask, value = synthetic_pair(64, 80, 12)
    s1 = DepthSession(rgb, DiffusionConfig(max_iterations=60))
    s1.mask_np[:] = mask
    s1.value_np[:] = value
    s1.set_color_key(4)
    s1.solve()
    ckpt = str(tmp_path / "sess.npz")
    s1.save_checkpoint(ckpt)

    s2 = DepthSession(rgb, DiffusionConfig(max_iterations=60))
    s2.load_checkpoint(ckpt)
    assert s2.scribble_color == 254 and s2.solve_count == 1
    assert np.array_equal(s2.mask_np, s1.mask_np)
    # depth-state pyramid fully restored -> identical re-solve
    d1 = s1.solve()
    d2 = s2.solve()
    assert np.array_equal(d1, d2)


def test_cli_checkpoint_resume(tmp_path):
    from realtimedepthdiffusion.live.cli import main as cli_main

    rgb, mask, value = synthetic_pair(64, 80, 13)
    img = str(tmp_path / "i.png")
    imwrite(img, rgb)
    ann = str(tmp_path / "a.png")
    save_annotation(ann, mask, value)
    ck = str(tmp_path / "c.npz")
    rc = cli_main(["-i", img, "-a", ann, "--headless", "--solve",
                   "--checkpoint", ck, "--backend", "xla"])
    assert rc == 0 and os.path.exists(ck)
    out = str(tmp_path / "o")
    os.makedirs(out)
    rc = cli_main(["-i", img, "--headless", "--resume", ck, "--solve",
                   "--save-dir", out, "--backend", "xla"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "DepthMap.png"))


@pytest.mark.slow
def test_serve_multichip_matches_sequential(tmp_path):
    """rtdd-serve --multichip (batched_step over the 8-device CPU mesh,
    shape-bucketed + padded last batch) produces per-pair depth maps matching
    the sequential single-chip path — the round-2 verdict's production entry
    point for parallel/sharded.py."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    # 3 pairs of one shape (batch of 2 -> padded last batch) + 1 of another
    # (bucket smaller than the batch) + 1 ODD-dimensioned (most dataset
    # images are odd — 853x1280, 685x1280, ... — and jit in_shardings reject
    # spatial specs that don't divide, so odd shapes must fall back to
    # batch-only input placement; regression for the round-3 fix).
    for name, (h, w), seed in [
        ("a", (64, 80), 1), ("b", (64, 80), 2), ("c", (64, 80), 5),
        ("dd", (72, 96), 3), ("ee", (69, 85), 4),
    ]:
        _write_pair(d, name, h, w, seed)
    img_dir, ann_dir = os.path.join(d, "images"), os.path.join(d, "annotations")

    # Reduced budget: the CPU-mesh batched step unrolls every sweep into one
    # traced program, so the full 1000-iteration schedule is compile-bound
    # here; 64 iterations keep the whole sharded structure exercised.
    out_seq = os.path.join(d, "out_seq")
    assert serve_main([
        "--images", img_dir, "--annotations", ann_dir,
        "--out", out_seq, "--backend", "xla", "--effect", "h",
        "--iterations", "64",
    ]) == 0
    out_mc = os.path.join(d, "out_mc")
    assert serve_main([
        "--images", img_dir, "--annotations", ann_dir,
        "--out", out_mc, "--backend", "xla", "--effect", "h",
        "--multichip", "--batch", "2", "--iterations", "64", "--depth16",
    ]) == 0

    from PIL import Image

    for name in ("a", "b", "c", "dd", "ee"):
        seq = imread_gray(os.path.join(out_seq, f"{name}_depth.png")).astype(np.int32)
        mc = imread_gray(os.path.join(out_mc, f"{name}_depth.png")).astype(np.int32)
        # identical solves up to the sharded halo-block fp rounding (one u8
        # step after the round-trip through the display quantization)
        assert np.abs(seq - mc).max() <= 1, name
        assert os.path.exists(os.path.join(out_mc, f"{name}_effect.png"))
        # --depth16 writes the 16-bit map on the multichip path too,
        # consistent with the 8-bit map up to rounding.
        d16 = np.asarray(
            Image.open(os.path.join(out_mc, f"{name}_depth16.png"))
        ).astype(np.int32)
        assert np.abs(d16 // 257 - mc).max() <= 1, name


def test_serve_async_pipeline_matches_sequential(tmp_path):
    """The async IO pipeline (decode-ahead threads, deferred readback,
    threaded PNG writes) must produce byte-identical outputs, in input
    order, to the strictly sequential path (prefetch=0, io_workers=1) —
    it reorders host work only, never device math."""
    from realtimedepthdiffusion.serve import discover_pairs, solve_pairs

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    for i, (name, h, w) in enumerate(
        [("a", 64, 80), ("b", 64, 80), ("c", 72, 96), ("d", 64, 80)]
    ):
        _write_pair(d, name, h, w, i + 1)
    pairs = discover_pairs(
        os.path.join(d, "images"), os.path.join(d, "annotations")
    )
    cfg = DiffusionConfig(backend="xla")
    from realtimedepthdiffusion.core import effects as fx

    seq = solve_pairs(pairs, os.path.join(d, "seq"), cfg, fx.EFFECT_HAZE,
                      io_workers=1, prefetch=0)
    par = solve_pairs(pairs, os.path.join(d, "par"), cfg, fx.EFFECT_HAZE,
                      io_workers=4, prefetch=3)
    assert [os.path.basename(p) for p in seq] == [
        os.path.basename(p) for p in par
    ]
    assert [os.path.basename(p) for p in seq] == [
        "a_depth.png", "b_depth.png", "c_depth.png", "d_depth.png"
    ]
    for s, p in zip(seq, par):
        with open(s, "rb") as f1, open(p, "rb") as f2:
            assert f1.read() == f2.read(), s
        e1 = s.replace("_depth.png", "_effect.png")
        e2 = p.replace("_depth.png", "_effect.png")
        with open(e1, "rb") as f1, open(e2, "rb") as f2:
            assert f1.read() == f2.read(), e1


def test_serve_multichip_bounded_decode(tmp_path, monkeypatch):
    """The multichip path buckets by image HEADER and decodes lazily: batch
    k's pixels are decoded only after batch k-1 has been dispatched, so host
    RAM holds at most ~two decoded batches no matter how long the queue is
    (the round-3 review finding: the first version decoded EVERYTHING up
    front)."""
    import realtimedepthdiffusion.parallel.sharded as sharded
    import realtimedepthdiffusion.serve as serve_mod
    from realtimedepthdiffusion.parallel.mesh import make_mesh
    from realtimedepthdiffusion.serve import solve_pairs_multichip

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    names = ["a", "b", "c", "d"]
    for i, name in enumerate(names):
        _write_pair(d, name, 48, 64, i + 1)
    pairs = [
        (os.path.join(d, "images", f"{n}.png"),
         os.path.join(d, "annotations", f"{n}.png"))
        for n in names
    ]

    events = []  # ("decode", stem) from pool threads / ("dispatch", #) main
    real_load = serve_mod._load_pair

    def spy_load(img_path, ann_path, cfg):
        events.append(("decode", os.path.basename(img_path)))
        return real_load(img_path, ann_path, cfg)

    real_step = sharded.batched_step
    n_dispatch = [0]

    def spy_step(*a, **kw):
        fn, meta = real_step(*a, **kw)

        def wrapped(*fa):
            events.append(("dispatch", n_dispatch[0]))
            n_dispatch[0] += 1
            return fn(*fa)

        return wrapped, meta

    monkeypatch.setattr(serve_mod, "_load_pair", spy_load)
    monkeypatch.setattr(sharded, "batched_step", spy_step)

    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    out = os.path.join(d, "out")
    got = solve_pairs_multichip(pairs, out, cfg, batch=1, mesh=make_mesh(1))
    assert len(got) == 4 and all(os.path.exists(p) for p in got)

    # batch=1 on a 1-device mesh -> 4 batches. Decode of batch k (k >= 2)
    # must come after dispatch of batch k-2 (one-batch decode-ahead).
    decode_at = {}
    dispatch_at = {}
    for idx, (kind, tag) in enumerate(events):
        if kind == "decode":
            decode_at[tag] = idx
        else:
            dispatch_at[tag] = idx
    assert n_dispatch[0] == 4
    for k in range(2, 4):
        assert decode_at[f"{names[k]}.png"] > dispatch_at[k - 2], events


def test_serve_keep_going_skips_bad_pairs(tmp_path):
    """--keep-going: a corrupt/mismatched pair becomes a warning + None entry
    and the rest of the run completes; without it the run aborts (fail-fast
    default). Covers both serving paths and the CLI exit code."""
    from realtimedepthdiffusion.serve import solve_pairs

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 48, 64, 1)
    _write_pair(d, "b", 48, 64, 2)
    # 'bad': annotation shape mismatches its image
    rgb, mask, value = synthetic_pair(48, 64, 3)
    imwrite(os.path.join(d, "images", "bad.png"), rgb)
    m2, v2 = synthetic_pair(40, 56, 3)[1:]
    save_annotation(os.path.join(d, "annotations", "bad.png"), m2, v2)
    pairs = discover_pairs_local(d)
    assert [os.path.basename(p) for p, _ in pairs] == ["a.png", "b.png", "bad.png"]

    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    with pytest.raises(ValueError):
        solve_pairs(pairs, os.path.join(d, "o0"), cfg)

    got = solve_pairs(pairs, os.path.join(d, "o1"), cfg, keep_going=True)
    assert got[2] is None
    assert got[0] and got[1] and all(os.path.exists(p) for p in got[:2])

    # CLI: --keep-going exits 1 when pairs were skipped, 0 when all solved.
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "o2"), "--backend", "xla",
        "--iterations", "16", "--keep-going",
    ])
    assert rc == 1
    assert os.path.exists(os.path.join(d, "o2", "a_depth.png"))
    assert os.path.exists(os.path.join(d, "o2", "b_depth.png"))
    assert not os.path.exists(os.path.join(d, "o2", "bad_depth.png"))

    # Multichip path: survivors re-pack the batch; bad pair skipped.
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "o3"), "--backend", "xla",
        "--iterations", "16", "--keep-going", "--multichip", "--batch", "2",
    ])
    assert rc == 1
    assert os.path.exists(os.path.join(d, "o3", "a_depth.png"))
    assert os.path.exists(os.path.join(d, "o3", "b_depth.png"))
    assert not os.path.exists(os.path.join(d, "o3", "bad_depth.png"))

    # --skip-existing: a re-run only attempts the still-missing pairs (here
    # just the broken one), so resume-after-partial-failure is cheap.
    a_mtime = os.path.getmtime(os.path.join(d, "o2", "a_depth.png"))
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "o2"), "--backend", "xla",
        "--iterations", "16", "--keep-going", "--skip-existing",
    ])
    assert rc == 1  # the bad pair still fails
    assert os.path.getmtime(os.path.join(d, "o2", "a_depth.png")) == a_mtime

    # --skip-existing + --effect: a pair is done only when EVERY requested
    # output exists. Depth PNGs from the effect-less run above must NOT
    # cause the effect re-run to skip the pair (its effect image is missing).
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "o2"), "--backend", "xla",
        "--iterations", "16", "--keep-going", "--skip-existing",
        "--effect", "h",
    ])
    assert rc == 1  # the bad pair still fails
    assert os.path.exists(os.path.join(d, "o2", "a_effect.png"))
    assert os.path.exists(os.path.join(d, "o2", "b_effect.png"))
    # ... and once both outputs exist the pair IS skipped (depth untouched).
    a_mtime2 = os.path.getmtime(os.path.join(d, "o2", "a_depth.png"))
    e_mtime = os.path.getmtime(os.path.join(d, "o2", "a_effect.png"))
    rc = serve_main([
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", os.path.join(d, "o2"), "--backend", "xla",
        "--iterations", "16", "--keep-going", "--skip-existing",
        "--effect", "h",
    ])
    assert rc == 1
    assert os.path.getmtime(os.path.join(d, "o2", "a_depth.png")) == a_mtime2
    assert os.path.getmtime(os.path.join(d, "o2", "a_effect.png")) == e_mtime


def discover_pairs_local(d):
    return discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))


def test_image_size_header_probe(tmp_path):
    """io.image_size reads (H, W) from the header without decoding pixels,
    and agrees with imread_rgb's shape (multichip serving buckets by it)."""
    from realtimedepthdiffusion.io import image_size, imread_rgb

    p = str(tmp_path / "im.png")
    imwrite(p, np.zeros((37, 53, 3), np.uint8))
    assert image_size(p) == (37, 53)
    assert imread_rgb(p).shape[:2] == image_size(p)


@pytest.mark.parametrize("from_env", [False, True])
def test_compilation_cache_helper(tmp_path, monkeypatch, from_env):
    """The compile cache is JAX_COMPILATION_CACHE_DIR when that is set (JAX
    reads it itself; nothing is set in code), else <checkout>/.jax_cache;
    RTDD_NO_COMPILE_CACHE opts out."""
    from realtimedepthdiffusion.utils import cache

    import jax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.CHECKOUT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
        want = str(tmp_path / "xla")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = cache.CHECKOUT_CACHE_DIR
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert cache.cache_dir() == want
        assert cache.enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == (None if from_env else want)

        monkeypatch.setenv("RTDD_NO_COMPILE_CACHE", "1")
        assert cache.enable_compilation_cache() is None
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_serve_multichip_async_writes_identical_and_last_wins(tmp_path):
    """The multichip encode pool (round 4: PNG encodes no longer serialize
    against the dispatch thread) reorders host work only — outputs must be
    byte-identical across io_workers settings — and duplicate stems keep
    the single-chip last-wins contract: only the winner encodes, the
    duplicate reports the winner's path only once it is on disk."""
    from realtimedepthdiffusion.parallel.mesh import make_mesh
    from realtimedepthdiffusion.serve import solve_pairs_multichip

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "x", 48, 64, 1)
    rgb2, mask2, value2 = synthetic_pair(48, 64, 7)
    imwrite(os.path.join(d, "images", "x2.png"), rgb2)
    save_annotation(os.path.join(d, "annotations", "x2.png"), mask2, value2)
    _write_pair(d, "y", 48, 64, 3)
    _write_pair(d, "z", 56, 72, 4)  # second shape bucket

    img = os.path.join(d, "images", "x.png")
    ann = os.path.join(d, "annotations", "x.png")
    ann2 = os.path.join(d, "annotations", "x2.png")
    py = (os.path.join(d, "images", "y.png"),
          os.path.join(d, "annotations", "y.png"))
    pz = (os.path.join(d, "images", "z.png"),
          os.path.join(d, "annotations", "z.png"))
    # Duplicate stem 'x': same image with two annotations (last wins).
    pairs = [(img, ann), py, (img, ann2), pz]
    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    mesh = make_mesh(1)

    seen = []

    def progress(src, dst):
        seen.append((src, dst, os.path.exists(dst)))

    out1 = os.path.join(d, "o1")
    got1 = solve_pairs_multichip(pairs, out1, cfg, batch=2, mesh=mesh,
                                 io_workers=4, progress=progress)
    # Global input order; the duplicate reports the winner's path.
    assert [os.path.basename(p) for p in got1] == [
        "x_depth.png", "y_depth.png", "x_depth.png", "z_depth.png"
    ]
    assert len(seen) == 4 and all(existed for _, _, existed in seen), seen

    out2 = os.path.join(d, "o2")
    got2 = solve_pairs_multichip(pairs, out2, cfg, batch=2, mesh=mesh,
                                 io_workers=1)
    for p1, p2 in zip(got1, got2):
        with open(p1, "rb") as f1, open(p2, "rb") as f2:
            assert f1.read() == f2.read(), p1

    # Last-wins content: stem x equals a solo run of the LAST x pair.
    out3 = os.path.join(d, "o3")
    solo = solve_pairs_multichip([(img, ann2)], out3, cfg, batch=2,
                                 mesh=mesh, io_workers=1)
    with open(got1[2], "rb") as f1, open(solo[0], "rb") as f2:
        assert f1.read() == f2.read()


def test_serve_duplicate_stems_last_wins(tmp_path):
    """Two pairs sharing an output stem must not race their threaded PNG
    writes: only the final occurrence encodes (the sequential loop's
    last-wins overwrite semantics), and both report the shared path."""
    from realtimedepthdiffusion.serve import solve_pairs

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "x", 64, 80, 1)
    rgb2, mask2, value2 = synthetic_pair(64, 80, 7)  # different annotation
    imwrite(os.path.join(d, "images", "x2.png"), rgb2)
    save_annotation(os.path.join(d, "annotations", "x2.png"), mask2, value2)

    img = os.path.join(d, "images", "x.png")
    ann = os.path.join(d, "annotations", "x.png")
    img2 = os.path.join(d, "images", "x2.png")
    ann2 = os.path.join(d, "annotations", "x2.png")
    cfg = DiffusionConfig(backend="xla")

    # Same stem twice (x.png then x2.png renamed onto stem x via pairs of
    # (image, annotation) lists that alias the stem): emulate by passing the
    # same image path with two different annotations.
    out = os.path.join(d, "out")
    seen = []  # (src, dst, dst existed when reported)

    def progress(src, dst):
        seen.append((src, dst, os.path.exists(dst)))

    got = solve_pairs([(img, ann), (img, ann2)], out, cfg,
                      io_workers=4, prefetch=2, progress=progress)
    assert got[0] == got[1] == os.path.join(out, "x_depth.png")
    # Progress (including the dead duplicate's) only fires once the winning
    # PNG is on disk — a consumer that opens the reported path never 404s.
    assert len(seen) == 2
    assert all(existed for _, _, existed in seen), seen

    # Last-wins: the file content equals a solo run of the LAST pair.
    out2 = os.path.join(d, "out2")
    solo = solve_pairs([(img, ann2)], out2, cfg, io_workers=1, prefetch=0)
    with open(got[1], "rb") as f1, open(solo[0], "rb") as f2:
        assert f1.read() == f2.read()


def test_serve_depth16_full_precision(tmp_path):
    """--depth16 writes a 16-bit PNG carrying the solver's sub-u8 signal:
    u16 // 257 must agree with the 8-bit map up to the two paths' rounding,
    the PNG must round-trip as uint16, and --skip-existing must treat a pair
    without its depth16 output as NOT done (resume adds the missing file)."""
    from PIL import Image

    from realtimedepthdiffusion.io import depth_to_u16
    from realtimedepthdiffusion.pipeline import DepthPipeline

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")
    base = [
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", out, "--backend", "xla",
    ]
    assert serve_main(base + ["--depth16"]) == 0
    p16 = os.path.join(out, "a_depth16.png")
    assert os.path.exists(p16)
    d16 = np.asarray(Image.open(p16)).astype(np.uint16)
    d8 = imread_gray(os.path.join(out, "a_depth.png"))
    assert d16.dtype == np.uint16 and d16.shape == d8.shape
    # u16 = rint(depth*257), u8 = rint(depth): integer-divided they agree
    # up to the 1-level rounding skew near .5 boundaries.
    assert np.abs((d16 // 257).astype(int) - d8.astype(int)).max() <= 1
    # The 16-bit map must carry sub-u8 precision (not just u8 * 257).
    assert np.any(d16 % 257 != 0)

    # Host and device conversions are the same float32 operation.
    rng_depth = np.random.default_rng(0).uniform(0, 255, (16, 24)).astype(np.float32)
    pipe = DepthPipeline(16, 24, DiffusionConfig(backend="xla"))
    np.testing.assert_array_equal(
        np.asarray(pipe.depth_u16(jnp.asarray(rng_depth))),
        depth_to_u16(rng_depth),
    )

    # skip-existing: depth+effect present but depth16 missing -> re-solves.
    os.remove(p16)
    rc = serve_main(base + ["--depth16", "--skip-existing"])
    assert rc == 0
    assert os.path.exists(p16)
    # And with every output present the pair is skipped (0 solved of 0).
    rc = serve_main(base + ["--depth16", "--skip-existing"])
    assert rc == 0


def test_serve_report_manifest(tmp_path):
    """--report writes a JSON manifest with one entry per INPUT pair in
    input order: solved pairs carry their depth path, --keep-going failures
    are 'failed', and a resumed run marks prior outputs 'skipped_existing'."""
    import json

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    _write_pair(d, "a", 64, 80, 1)
    _write_pair(d, "b", 64, 80, 2)
    with open(os.path.join(d, "images", "broken.png"), "wb") as f:
        f.write(b"not a png")
    save_annotation(
        os.path.join(d, "annotations", "broken.png"),
        np.zeros((8, 8), bool), np.zeros((8, 8), np.uint8),
    )
    out = os.path.join(d, "out")
    rep1 = os.path.join(d, "run1.json")
    base = [
        "--images", os.path.join(d, "images"),
        "--annotations", os.path.join(d, "annotations"),
        "--out", out, "--backend", "xla", "--keep-going",
    ]
    assert serve_main(base + ["--report", rep1]) == 1  # broken pair skipped
    r = json.load(open(rep1))
    by_name = {os.path.basename(e["image"]): e for e in r["pairs"]}
    assert r["counts"] == {"total": 3, "solved": 2,
                           "skipped_existing": 0, "failed": 1}
    assert by_name["a.png"]["status"] == "solved"
    assert os.path.exists(by_name["a.png"]["depth"])
    # Solved pairs carry the dispatch-to-readback device latency; 'b'
    # reuses 'a's shape programs so it must not re-pay acquisition.
    assert by_name["a.png"]["solve_s"] > 0
    assert 0 < by_name["b.png"]["solve_s"] <= by_name["a.png"]["solve_s"]
    assert "solve_s" not in by_name["broken.png"]
    assert by_name["broken.png"] == {
        "image": os.path.join(d, "images", "broken.png"),
        "annotation": os.path.join(d, "annotations", "broken.png"),
        "status": "failed", "depth": None,
    }
    assert r["wall_s"] > 0 and r["config"]["backend"] == "xla"

    # Resume: a/b become skipped_existing, broken stays failed.
    rep2 = os.path.join(d, "run2.json")
    assert serve_main(base + ["--skip-existing", "--report", rep2]) == 1
    r2 = json.load(open(rep2))
    assert r2["counts"] == {"total": 3, "solved": 0,
                            "skipped_existing": 2, "failed": 1}
    assert {os.path.basename(e["image"]): e["status"] for e in r2["pairs"]} == {
        "a.png": "skipped_existing", "b.png": "skipped_existing",
        "broken.png": "failed",
    }


@pytest.mark.slow
def test_serve_watch_soak_lru_fails_and_sigterm_manifest(tmp_path):
    """Watch-mode soak (round-4 verdict task #8): drive the service through
    many add/modify/delete cycles across max_shapes+2 distinct shapes plus
    one persistently-broken annotation, then SIGTERM. Pins the round-4
    hardening as a regression test: the resident-pipeline LRU bound holds
    under churn (eviction messages fire, process RSS stays bounded), the
    per-image fails bookkeeping gives up after the attempt cap each time
    the broken file is touched (no per-signature leak: one give-up burst
    per touch), and the FINAL manifest written on SIGTERM covers every
    pair ever seen with truthful statuses."""
    import json
    import re
    import signal
    import subprocess
    import sys

    d = str(tmp_path)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "annotations"))
    shapes = [(48, 64), (56, 72), (64, 80), (48, 80)]  # max_shapes=2, +2
    for i, (h, w) in enumerate(shapes):
        _write_pair(d, f"s{i}", h, w, i + 1)
    # Persistently-broken annotation: wrong shape vs its image.
    rgb, _, _ = synthetic_pair(48, 64, 9)
    imwrite(os.path.join(d, "images", "bad.png"), rgb)
    _rgb2, m2, v2 = synthetic_pair(24, 32, 9)
    save_annotation(os.path.join(d, "annotations", "bad.png"), m2, v2)

    out = os.path.join(d, "out")
    rep = os.path.join(d, "rep.json")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "realtimedepthdiffusion.serve",
         "--images", os.path.join(d, "images"),
         "--annotations", os.path.join(d, "annotations"),
         "--out", out, "--backend", "xla", "--watch",
         "--poll-interval", "0.1", "--max-shapes", "2",
         "--iterations", "40", "--report", rep],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )

    def rss_mb():
        with open(f"/proc/{proc.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    def wait_outputs(names, deadline_s=240):
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            if all(
                os.path.exists(os.path.join(out, f"{n}_depth.png"))
                for n in names
            ):
                return
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        raise AssertionError(f"outputs never appeared: {names}")

    try:
        wait_outputs([f"s{i}" for i in range(4)])
        rss_warm = rss_mb()
        # Churn: rotate modifications across all shapes + the broken pair,
        # with periodic delete/re-add of one image. Each annotation rewrite
        # changes the pair's signature, forcing re-solves (and, for evicted
        # shapes, pipeline re-acquisition under the LRU bound).
        stamps = {}
        for cyc in range(12):
            i = cyc % 4
            h, w = shapes[i]
            _r, m, v = synthetic_pair(h, w, 20 + cyc)
            save_annotation(
                os.path.join(d, "annotations", f"s{i}.png"), m,
                np.where(m, (v.astype(int) + cyc * 7) % 255, 0).astype(np.uint8),
            )
            stamps[f"s{i}"] = os.path.getmtime(
                os.path.join(d, "annotations", f"s{i}.png")
            )
            os.utime(os.path.join(d, "annotations", "bad.png"))  # re-arm
            if cyc == 5:
                os.unlink(os.path.join(d, "images", "s3.png"))  # delete
            if cyc == 8:
                r3, _m, _v = synthetic_pair(*shapes[3], 99)
                imwrite(os.path.join(d, "images", "s3.png"), r3)  # re-add
            time.sleep(1.2)
        time.sleep(4.0)  # let the final batch settle
        rss_end = rss_mb()
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    # Exit 1: the given-up broken pair is flagged (the batch-mode contract;
    # a healthy soak without 'bad' exits 0 via the SIGTERM path).
    assert proc.returncode == 1, (proc.returncode, stderr[-3000:])
    # LRU bound: with 4 shapes churning over a 2-shape cap, evictions MUST
    # have fired; and the bounded residency keeps RSS from runaway growth
    # across the soak (generous 1.6x + 200MB band: the bound is about
    # unbounded-leak detection, not exact accounting).
    assert "evicted" in stderr, stderr[-3000:]
    assert rss_end < rss_warm * 1.6 + 200.0, (rss_warm, rss_end)
    # Fails bookkeeping: the broken pair was given up on (attempt cap) and
    # its stale outputs removed; re-arming by touch produced repeated
    # give-up bursts rather than a single permanent skip.
    gave_up = re.findall(r"giving up on .*bad\.png", stderr)
    assert len(gave_up) >= 2, stderr[-3000:]
    assert not os.path.exists(os.path.join(out, "bad_depth.png"))
    # Final manifest on SIGTERM: every pair ever seen, truthful statuses.
    data = json.load(open(rep))
    by = {os.path.basename(e["image"]): e for e in data["pairs"]}
    assert by["bad.png"]["status"] == "failed"
    assert by["bad.png"]["depth"] is None
    for i in range(4):
        e = by[f"s{i}.png"]
        assert e["status"] == "solved", e
        assert os.path.exists(e["depth"])
    # The re-solves actually tracked the rewritten annotations: the last
    # written depth for a churned shape postdates its last rewrite.
    for name, ts in stamps.items():
        if name == "s3":
            continue  # deleted/re-added mid-soak; covered by status above
        assert os.path.getmtime(os.path.join(out, f"{name}_depth.png")) >= ts
