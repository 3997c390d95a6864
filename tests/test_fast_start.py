"""Cold-start (cfg.fast_start) tests: the staged per-level path must be
bit-identical to the fused whole-cascade program, the pipeline must switch
to the fused executable once its background compile lands, and the live
incremental gate must never block a frame on a compile.

The suite-wide default is fast_start=False (tests/conftest.py pins
RTDD_FAST_START=0 so background compiles never race the single test CPU);
these tests opt in explicitly.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.pipeline import DepthPipeline, _StagedCascade
from tests.conftest import synthetic_pair


def _solve_args(pipe, rgb, mask, value):
    rgb_d, gpyr = pipe.prepare_image(rgb)
    return rgb_d, gpyr, jnp.asarray(mask), jnp.asarray(value)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_staged_matches_fused_bitwise(backend):
    """The staged split points (pyrUp/seed between per-level programs)
    carry no arithmetic, so staged and fused outputs must be BIT-identical
    — the property that lets fast_start swap programs mid-session without
    any observable change. Checked on both the XLA solver path and the
    coarse-level kernel (interpret mode)."""
    rgb, mask, value = synthetic_pair(64, 96, 3)
    iters = 40 if backend == "pallas_interpret" else 200
    cfg_fused = DiffusionConfig(
        backend=backend, max_iterations=iters, fast_start=False
    )
    cfg_fast = dataclasses.replace(cfg_fused, fast_start=True)

    pipe_f = DepthPipeline(64, 96, cfg_fused)
    _, gpyr, m, v = _solve_args(pipe_f, rgb, mask, value)
    d_fused, st_fused = pipe_f.solve(gpyr, m, v, pipe_f.initial_state())

    pipe_s = DepthPipeline(64, 96, cfg_fast)
    # Freeze the background compile so the first solve provably runs staged.
    pipe_s._kick = lambda *a, **kw: None
    d_staged, st_staged = pipe_s.solve(gpyr, m, v, pipe_s.initial_state())
    assert pipe_s._staged is not None  # the staged path was actually taken

    np.testing.assert_array_equal(np.asarray(d_fused), np.asarray(d_staged))
    for a, b in zip(st_fused, st_staged):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_background_compiles_never_trace_off_caller_thread():
    """JAX tracing/lowering is not safe to run concurrently with the main
    thread's own traces: a background lower() racing the incremental
    program's trace produced a malformed jaxpr (KeyError on the omega
    schedule constant — examples/02 regression). Contract: _kick and
    prewarm_async trace+lower ON THE CALLER THREAD; only the GIL-releasing
    XLA compile() runs on the background thread."""
    import threading

    from realtimedepthdiffusion import pipeline as pipeline_mod

    cfg = DiffusionConfig(backend="xla", max_iterations=40, fast_start=True)
    pipe = DepthPipeline(64, 96, cfg)
    main_id = threading.get_ident()
    seen = {}

    class FakeLowered:
        def compile(self):
            seen["compile_thread"] = threading.get_ident()
            return "fake-executable"

    def lower_fn():
        seen["lower_thread"] = threading.get_ident()
        return FakeLowered()

    pipe._kick(("probe",), lower_fn)
    assert seen["lower_thread"] == main_id
    t = pipe._compile_threads[("probe",)]
    t.join(timeout=30)
    assert seen["compile_thread"] == t.ident != main_id
    assert pipe._aot[("probe",)] == "fake-executable"

    # prewarm_async: lower_all on the caller, compile_from on the thread.
    ids = {}
    real_lower_all = pipeline_mod._StagedCascade.lower_all
    real_compile_from = pipeline_mod._StagedCascade.compile_from

    def spy_lower_all(self):
        ids["lower"] = threading.get_ident()
        return real_lower_all(self)

    def spy_compile_from(self, lowered):
        ids["compile"] = threading.get_ident()
        return real_compile_from(self, lowered)

    pipeline_mod._StagedCascade.lower_all = spy_lower_all
    pipeline_mod._StagedCascade.compile_from = spy_compile_from
    try:
        pipe2 = DepthPipeline(64, 96, cfg)
        pipe2.prewarm_async()
        pipe2._staged_thread.join(timeout=60)
    finally:
        pipeline_mod._StagedCascade.lower_all = real_lower_all
        pipeline_mod._StagedCascade.compile_from = real_compile_from
    assert ids["lower"] == main_id
    assert ids["compile"] == pipe2._staged_thread.ident != main_id
    assert pipe2._staged is not None


def test_prewarm_async_overlaps_and_first_solve_joins():
    """prewarm_async starts the staged compile on a background thread
    (session init overlaps it); the first solve joins via _ensure_staged's
    lock and produces the same bits as an un-prewarmed pipeline. Idempotent,
    and a no-op when fast_start is off."""
    rgb, mask, value = synthetic_pair(64, 96, 3)
    cfg = DiffusionConfig(backend="xla", max_iterations=120, fast_start=True)

    pipe = DepthPipeline(64, 96, cfg)
    pipe._kick = lambda *a, **kw: None  # isolate: no fused compile
    pipe.prewarm_async()
    t = pipe._staged_thread
    assert t is not None
    pipe.prewarm_async()  # idempotent: same thread, no respawn
    assert pipe._staged_thread is t
    _, gpyr, m, v = _solve_args(pipe, rgb, mask, value)
    d1, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert pipe._staged is not None  # joined and used the prewarmed programs
    t.join(timeout=60)
    assert not t.is_alive()

    ref = DepthPipeline(64, 96, cfg)
    ref._kick = lambda *a, **kw: None
    d2, _ = ref.solve(gpyr, m, v, ref.initial_state())
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    off = DepthPipeline(64, 96, dataclasses.replace(cfg, fast_start=False))
    off.prewarm_async()
    assert off._staged_thread is None  # no-op without fast_start


def test_fast_start_switches_to_fused_and_results_stable():
    """First solve: staged, and NO background kick yet — a serialized
    compile service would queue the first frame's readback behind an
    in-flight compile for minutes (PERF.md Startup note 7). The second
    staged solve kicks the fused compile; after wait_fused, solves run the
    AOT fused executable — and produce the same bits, so the switch is
    unobservable."""
    from realtimedepthdiffusion.core import effects as fx

    rgb, mask, value = synthetic_pair(64, 96, 5)
    cfg = DiffusionConfig(backend="xla", max_iterations=120, fast_start=True)
    pipe = DepthPipeline(64, 96, cfg)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = jnp.asarray(mask), jnp.asarray(value)

    d1, st1 = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert pipe._staged is not None
    assert ("solve",) not in pipe._compile_threads  # note-7 deferral
    d1b, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d1b))
    assert ("solve",) in pipe._compile_threads  # second solve kicks

    assert pipe.wait_fused(timeout=120)
    assert ("solve",) in pipe._aot

    calls = []
    real = _StagedCascade.__call__

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    _StagedCascade.__call__ = spy
    try:
        d2, st2 = pipe.solve(gpyr, m, v, pipe.initial_state())
    finally:
        _StagedCascade.__call__ = real
    assert not calls, "fused executable landed but staged path still ran"
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    # solve_and_effect: staged+standalone-effect == fused, bitwise.
    d3, st3, art3 = pipe.solve_and_effect(
        fx.EFFECT_HAZE, gpyr, rgb_d, m, v, pipe.initial_state()
    )
    assert pipe.wait_fused(timeout=120)
    d4, st4, art4 = pipe.solve_and_effect(
        fx.EFFECT_HAZE, gpyr, rgb_d, m, v, pipe.initial_state()
    )
    np.testing.assert_array_equal(np.asarray(art3), np.asarray(art4))
    np.testing.assert_array_equal(np.asarray(d3), np.asarray(d4))


def test_fast_start_aval_mismatch_falls_back():
    """An AOT executable only serves exactly the avals it was lowered for;
    unusual dtypes (e.g. a uint8 mask) must route to the plain jit path,
    not crash the AOT call."""
    rgb, mask, value = synthetic_pair(64, 96, 4)
    cfg = DiffusionConfig(backend="xla", max_iterations=60, fast_start=True)
    pipe = DepthPipeline(64, 96, cfg)
    _, gpyr = pipe.prepare_image(rgb)
    pipe.solve(gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state())
    assert pipe.wait_fused(timeout=120)

    # uint8 mask instead of bool: jit path (recompile), same numbers.
    d_u8, _ = pipe.solve(
        gpyr, jnp.asarray(mask.astype(np.uint8)), jnp.asarray(value),
        pipe.initial_state(),
    )
    d_b, _ = pipe.solve(
        gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state()
    )
    np.testing.assert_array_equal(np.asarray(d_u8), np.asarray(d_b))


def test_incremental_gate_never_blocks(monkeypatch):
    """While the incremental program's background compile has not landed,
    the live loop must take the full warm re-solve (already compiled), not
    block the frame; once it lands, small strokes take the windowed path."""
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, mask, value = synthetic_pair(80, 96, 9)
    cfg = DiffusionConfig(
        backend="xla", max_iterations=120, incremental_iterations=60,
        fast_start=True,
    )
    s = DepthSession(rgb, cfg)
    s.mask_np[:] = mask
    s.value_np[:] = value
    s.dirty = (0, 0, 79, 95)
    s.solve()  # first solve: full budget

    # Freeze "not ready": drop the landed executable (and its thread-key so
    # a later kick can restart it) and silence the kick.
    s.pipe._aot.pop(("inc",), None)
    s.pipe._compile_threads.pop(("inc",), None)
    monkeypatch.setattr(type(s.pipe), "_kick", lambda *a, **kw: None)

    win_calls = []
    real_inc = type(s.pipe).solve_incremental
    monkeypatch.setattr(
        type(s.pipe), "solve_incremental",
        lambda self, *a, **kw: (win_calls.append(1), real_inc(self, *a, **kw))[1],
    )
    s.set_color_key(2)
    s.paint(48, 40)
    s.solve()
    assert not win_calls, "frame blocked on the incremental compile"

    # Simulate the background compile landing; now the stroke goes windowed.
    monkeypatch.undo()
    s.pipe.incremental_ready(None)  # re-kick
    assert s.pipe.wait_fused(timeout=120)
    assert s.pipe.incremental_ready(None)
    monkeypatch.setattr(
        type(s.pipe), "solve_incremental",
        lambda self, *a, **kw: (win_calls.append(1), real_inc(self, *a, **kw))[1],
    )
    s.paint(50, 42)
    s.solve()
    assert win_calls, "windowed path not taken after the compile landed"


def test_incremental_works_with_background_compile_disabled(monkeypatch):
    """RTDD_BACKGROUND_COMPILE=0 (the serialized-compile-service escape
    hatch) must not silently turn --incremental off: with the kick path
    disabled, incremental_ready reports True and the first small stroke
    compiles the windowed program synchronously — one slow frame, then the
    feature works. (Pre-fix: _kick no-op'd, the key never landed in _aot,
    and every stroke fell back to the full re-solve for the whole
    session.)"""
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, mask, value = synthetic_pair(80, 96, 9)
    cfg = DiffusionConfig(
        backend="xla", max_iterations=120, incremental_iterations=60,
        fast_start=True,
    )
    s = DepthSession(rgb, cfg)
    s.pipe.background_compile = False
    if s._inc_pipe is not None:
        s._inc_pipe.background_compile = False
    s.mask_np[:] = mask
    s.value_np[:] = value
    s.dirty = (0, 0, 79, 95)
    s.solve()  # first solve: full budget

    assert s.pipe.incremental_ready(None, kick=False)
    win_calls = []
    real_inc = type(s.pipe).solve_incremental
    monkeypatch.setattr(
        type(s.pipe), "solve_incremental",
        lambda self, *a, **kw: (win_calls.append(1), real_inc(self, *a, **kw))[1],
    )
    s.set_color_key(2)
    s.paint(48, 40)
    s.solve()
    assert win_calls, (
        "windowed path not taken with background compiles disabled"
    )


def test_one_shot_headless_skips_background_compile(tmp_path, monkeypatch):
    """A headless one-shot run exits right after its solve: it must not
    start a background fused compile (the orphaned in-flight compile would
    only load the shared compile service — measured consequence in PERF.md
    'Startup')."""
    from PIL import Image

    import realtimedepthdiffusion.live.session as session_mod
    from realtimedepthdiffusion.live.cli import main

    monkeypatch.setenv("RTDD_FAST_START", "1")
    rgb, mask, value = synthetic_pair(64, 96, 2)
    img = tmp_path / "img.png"
    Image.fromarray(rgb).save(img)

    captured = []
    real = session_mod.DepthSession

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(session_mod, "DepthSession", Spy)
    rc = main(["-i", str(img), "--headless", "--solve"])
    assert rc == 0
    (s,) = captured
    assert s.cfg.fast_start  # env default applied
    assert s.pipe.background_compile is False
    assert not s.pipe._compile_threads  # nothing was kicked
    assert s.pipe._staged is not None  # the staged path served the solve


def test_warmup_tool(tmp_path, capsys, monkeypatch):
    """rtdd-warmup compiles the product programs for the requested shapes
    into the persistent cache; a session on a warmed shape then starts from
    disk instead of compiling."""
    from realtimedepthdiffusion import warmup

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    rc = warmup.main([
        "--size", "64x96", "--effect", "h", "--incremental", "40",
        "--iterations", "40", "--backend", "xla", "--jobs", "3",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "64x96: warmed in" in out
    assert "solve" in out and "incremental" in out
    # The cache is the one JAX_COMPILATION_CACHE_DIR names.
    assert f"persistent cache: {tmp_path / 'cache'}" in out

    # size parsing contract
    assert warmup.parse_size("1080p") == (1080, 1920)
    assert warmup.parse_size("4k") == (2160, 3840)
    assert warmup.parse_size("123x456") == (123, 456)
    with pytest.raises(SystemExit):
        warmup.main(["--size", "garbage"])
    assert warmup.main([]) == 2  # no shapes


def test_fast_start_env_default():
    """RTDD_FAST_START=0 (the suite default from conftest) pins the config
    default off; explicit construction overrides either way."""
    assert os.environ.get("RTDD_FAST_START") == "0"
    assert DiffusionConfig().fast_start is False
    assert DiffusionConfig(fast_start=True).fast_start is True


def test_exit_during_background_compile_is_clean(tmp_path):
    """Regression: exiting the interpreter while the background fused
    compile is still in flight used to SIGABRT the process — CPython kills
    daemon threads via pthread_exit when they next take the GIL, and the
    forced unwind crossing XLA's C++ compile frames trips 'FATAL: exception
    not rethrown'. pipeline._join_background_compiles (atexit) now joins
    in-flight compiles before finalization. The subprocess disables the
    persistent compile cache so the fused compile is genuinely in flight
    when the script falls off the end."""
    import subprocess
    import sys

    script = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "jax.config.update('jax_enable_compilation_cache', False);"
        "import numpy as np, jax.numpy as jnp;"
        "from realtimedepthdiffusion.config import DiffusionConfig;"
        "from realtimedepthdiffusion.pipeline import DepthPipeline;"
        "cfg = DiffusionConfig(fast_start=True, backend='xla');"
        "pipe = DepthPipeline(360, 480, cfg);"
        "rgb = np.zeros((360, 480, 3), np.uint8);"
        "m = np.zeros((360, 480), bool); m[10:20, 10:20] = True;"
        "v = np.where(m, 200, 0).astype(np.uint8);"
        "_, gp = pipe.prepare_image(rgb);"
        "d, _ = pipe.solve(gp, jnp.asarray(m), jnp.asarray(v),"
        " pipe.initial_state());"
        "d.block_until_ready();"
        # Second solve: the fused background compile is kicked from the
        # second staged solve on (note-7 deferral), and must be in flight
        # when the interpreter exits for this regression to bite.
        "d2, _ = pipe.solve(gp, jnp.asarray(m), jnp.asarray(v),"
        " pipe.initial_state());"
        "d2.block_until_ready();"
        "assert ('solve',) in pipe._compile_threads;"
        "print('RC-OK', flush=True)"
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", script], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert "RC-OK" in r.stdout, (r.stdout, r.stderr)
    assert r.returncode == 0, (r.returncode, r.stderr[-2000:])
