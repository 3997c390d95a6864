"""CLI contract + headless session tests (SURVEY.md C1/C5/C6/C18)."""

import os

import numpy as np
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.io import imread_gray, imwrite, load_annotation
from realtimedepthdiffusion.live.cli import main, parse_args
from realtimedepthdiffusion.live.session import DepthSession
from tests.conftest import synthetic_pair


def test_parse_args_reference_contract():
    a = parse_args(["-i", "img.jpg", "-a", "ann.png", "--live"])
    assert a.image == "img.jpg" and a.annotation == "ann.png" and a.live
    # unknown flags ignored, any order (src/main.cpp:81-90)
    a = parse_args(["--live", "-x", "-i", "img.jpg"])
    assert a.image == "img.jpg" and a.live


def test_cli_no_args_prints_usage(capsys):
    assert main([]) == 0
    assert "Usage" in capsys.readouterr().out


def test_session_paint_solve_save(tmp_path):
    rgb, mask, value = synthetic_pair(70, 90, 5)
    cfg = DiffusionConfig(max_iterations=60)
    s = DepthSession(rgb, cfg)
    # keys: pick depth '3' (=192), paint a stroke, radius bump
    s.set_color_key(3)
    assert s.scribble_color == 192
    s.adjust_radius(+2)
    s.paint(45, 35)
    s.set_color_key(0)
    s.paint(10, 10)
    d8 = s.solve()
    assert d8.shape == (70, 90) and d8.dtype == np.uint8
    assert d8[35, 45] == 192 and d8[10, 10] == 0  # scribbles pinned

    s.set_effect_key("h")
    art = s.render_effect()
    assert art.shape == rgb.shape

    p1, p2, p3 = s.save(str(tmp_path))
    for p in (p1, p2, p3):
        assert os.path.exists(p)
    # The annotation checkpoint round-trips
    m2, v2 = load_annotation(str(tmp_path / "Annotation.png"), cfg)
    assert m2[35, 45] and v2[35, 45] == 192
    # DepthMap.png stores the depth replicated to 3 channels
    dm = imread_gray(p2)
    assert dm[35, 45] == 192


def test_cli_headless_end_to_end(tmp_path):
    rgb, mask, value = synthetic_pair(70, 90, 6)
    img = str(tmp_path / "img.png")
    imwrite(img, rgb)
    ann = np.where(mask, value, 32).astype(np.uint8)
    annp = str(tmp_path / "ann.png")
    imwrite(annp, ann)

    out = str(tmp_path / "out")
    os.makedirs(out)
    rc = main([
        "-i", img, "-a", annp, "--headless", "--solve", "--effect", "g",
        "--save-dir", out, "--time", "--backend", "xla",
    ])
    assert rc == 0
    for f in ("AnnotatedImage.png", "Annotation.png", "DepthMap.png", "ArtisticEffect.png"):
        assert os.path.exists(os.path.join(out, f)), f
    # Depth honors an annotation scribble
    dm = imread_gray(os.path.join(out, "DepthMap.png"))
    ys, xs = np.nonzero(mask)
    assert abs(int(dm[ys[0], xs[0]]) - int(value[ys[0], xs[0]])) <= 1


def test_cli_depth16_writes_16bit_map(tmp_path):
    """--depth16 adds DepthMap16.png: 16-bit PNG, consistent with the 8-bit
    map up to rounding, carrying sub-u8 precision; the flag parses and the
    default save still writes exactly the reference's files."""
    from PIL import Image

    rgb, mask, value = synthetic_pair(70, 90, 6)
    img = str(tmp_path / "img.png")
    imwrite(img, rgb)
    annp = str(tmp_path / "ann.png")
    imwrite(annp, np.where(mask, value, 32).astype(np.uint8))

    out = str(tmp_path / "out")
    rc = main([
        "-i", img, "-a", annp, "--headless", "--solve",
        "--save-dir", out, "--depth16", "--backend", "xla",
    ])
    assert rc == 0
    p16 = os.path.join(out, "DepthMap16.png")
    assert os.path.exists(p16)
    d16 = np.asarray(Image.open(p16)).astype(np.uint16)
    d8 = imread_gray(os.path.join(out, "DepthMap.png"))
    assert d16.dtype == np.uint16
    assert np.abs((d16 // 257).astype(int) - d8.astype(int)).max() <= 1
    assert np.any(d16 % 257 != 0)  # real sub-u8 signal, not u8 * 257

    out2 = str(tmp_path / "out2")
    rc = main([
        "-i", img, "-a", annp, "--headless", "--solve",
        "--save-dir", out2, "--backend", "xla",
    ])
    assert rc == 0
    assert not os.path.exists(os.path.join(out2, "DepthMap16.png"))

    # The GUI 's' key defers to the session's save_depth16 preference
    # (set by the --depth16 flag), so both surfaces agree.
    from realtimedepthdiffusion.live.session import DepthSession
    s = DepthSession(rgb, DiffusionConfig(max_iterations=20, backend="xla"))
    s.paint(35, 35)
    s.solve()
    out3 = str(tmp_path / "out3")
    assert len(s.save(out3)) == 3  # preference off: reference's 3 PNGs
    s.save_depth16 = True
    out4 = str(tmp_path / "out4")
    paths = s.save(out4)
    assert len(paths) == 4 and paths[3].endswith("DepthMap16.png")
    assert os.path.exists(paths[3])


def test_session_timing_report():
    rgb, _, _ = synthetic_pair(64, 64, 7)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=30))
    s.paint(32, 32)
    s.solve()
    rep = s.timing_report()
    assert "Processing Time" in rep and "solve" in rep


def test_annotation_size_mismatch_raises(tmp_path):
    """Clean error propagation (SURVEY.md §5 failure handling): a wrong-size
    annotation raises instead of silently corrupting state."""
    import pytest as _pytest
    from realtimedepthdiffusion.io import save_annotation

    rgb, _, _ = synthetic_pair(70, 90, 8)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=20))
    mask = np.zeros((30, 40), bool)
    val = np.zeros((30, 40), np.uint8)
    p = str(tmp_path / "wrong.png")
    save_annotation(p, mask, val)
    with _pytest.raises(ValueError, match="does not match image"):
        s.load_annotation_file(p)


def test_cli_missing_flag_value():
    import pytest as _pytest

    with _pytest.raises(SystemExit, match="requires a value"):
        parse_args(["-i"])


def test_cli_effect_names():
    """--effect takes the GUI key letters or long names; an unknown value
    errors loudly (silently dropping it would save the reference's all-zeros
    ArtisticEffect, main.cpp:94,314-316 — indistinguishable from a crash)."""
    import pytest as _pytest

    for v, key in [("b", "b"), ("refocus", "b"), ("DEFOCUS", "b"),
                   ("g", "g"), ("desaturation", "g"),
                   ("h", "h"), ("haze", "h")]:
        assert parse_args(["-i", "x.jpg", "--effect", v]).effect == key
    with _pytest.raises(SystemExit, match="unknown --effect"):
        parse_args(["-i", "x.jpg", "--effect", "sepia"])


def test_gui_key_state_machine():
    """The GUI key contract as a displayless state machine (the reference's
    src/main.cpp:180-334 bindings), including the idle-frame/live semantics."""
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.live.gui import handle_key

    rgb, _, _ = synthetic_pair(64, 64, 3)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=20))

    assert handle_key(s, 27) is True  # Esc quits
    assert handle_key(s, 255) is False  # idle frame: no-op, no solve
    assert s.solve_count == 0

    handle_key(s, ord("3"))
    assert s.scribble_color == 192
    handle_key(s, ord("+"))
    r = s.scribble_radius
    handle_key(s, ord("-"))
    assert s.scribble_radius == r - 2

    s.paint(32, 32)
    handle_key(s, ord("d"))
    assert s.solve_count == 1  # 'd' solves

    handle_key(s, ord("h"))
    assert s.effect == fx.EFFECT_HAZE and s.artistic is not None
    handle_key(s, ord("b"))
    assert s.effect == fx.EFFECT_DEFOCUS  # sticky, mutually exclusive

    # idle frame under --live solves every tick
    assert handle_key(s, 255, live=True) is False
    assert s.solve_count == 2

    # the reference's branches are independent ifs (src/main.cpp:188-332):
    # a --live frame with any other key pressed STILL solves that frame
    n = s.solve_count
    handle_key(s, ord("2"), live=True)  # color change + live solve
    assert s.scribble_color == 128 and s.solve_count == n + 1
    handle_key(s, ord("+"), live=True)  # radius change + live solve
    assert s.solve_count == n + 2
    handle_key(s, ord("g"), live=True)  # effect latch + live solve (fused render)
    assert s.effect == fx.EFFECT_DESATURATION and s.solve_count == n + 3

    # a sticky effect re-renders every frame even without a solve
    # (src/main.cpp:190 `key=='b' || refocusEffect`)
    s.artistic = None
    handle_key(s, 255, live=False)
    assert s.artistic is not None


def test_cli_trace_and_verbose(tmp_path):
    """--trace wraps the solve in a jax.profiler trace (SURVEY §5
    observability); --verbose enables debug logging."""
    from realtimedepthdiffusion.io import imwrite, save_annotation

    rgb, mask, value = synthetic_pair(64, 64, 14)
    img = str(tmp_path / "i.png")
    imwrite(img, rgb)
    ann = str(tmp_path / "a.png")
    save_annotation(ann, mask, value)
    trace_dir = str(tmp_path / "trace")
    rc = main(["-i", img, "-a", ann, "--headless", "--solve", "--time",
               "--trace", trace_dir, "--verbose", "--backend", "xla"])
    assert rc == 0
    assert os.path.isdir(trace_dir) and len(os.listdir(trace_dir)) > 0


def test_cli_solver_flags_reach_config():
    """Round-2 verdict gap: the incremental live path, early exit and the
    gray-chain convention must be reachable from argv (the reference exposes
    its whole behavior surface through its CLI, src/main.cpp:81-90)."""
    from realtimedepthdiffusion.live.cli import make_config

    a = parse_args([
        "-i", "x.jpg", "--incremental", "48", "--early-exit",
        "--tolerance", "2e-5", "--gray-pyramid", "floor",
        "--solver", "red_black", "--residual-metric", "max",
    ])
    cfg = make_config(a)
    assert cfg.incremental_iterations == 48
    assert cfg.early_exit is True
    assert cfg.residual_metric == "max"
    assert cfg.tolerance == pytest.approx(2e-5)
    assert cfg.gray_pyramid == "floor"
    assert cfg.solver == "red_black"

    # --tolerance alone implies early exit (the reference declares a
    # tolerance it never uses; given explicitly, we honor it).
    cfg2 = make_config(parse_args(
        ["-i", "x.jpg", "--solver", "red_black", "--tolerance", "1e-4"]
    ))
    assert cfg2.early_exit is True and cfg2.tolerance == pytest.approx(1e-4)
    # defaults unchanged
    cfg3 = make_config(parse_args(["-i", "x.jpg"]))
    assert cfg3 == DiffusionConfig()

    with pytest.raises(SystemExit, match="integer"):
        parse_args(["--incremental", "abc"])
    with pytest.raises(SystemExit, match="number"):
        parse_args(["--tolerance", "abc"])

    # Every solver honors the early exit (round 5): --tolerance on the
    # default (reference) solver and --early-exit on plain jacobi both
    # resolve to working configs instead of erroring.
    cfg4 = make_config(parse_args(["-i", "x.jpg", "--tolerance", "1e-4"]))
    assert cfg4.solver == "jacobi_chebyshev" and cfg4.early_exit
    assert cfg4.tolerance == pytest.approx(1e-4)
    cfg5 = make_config(parse_args(
        ["-i", "x.jpg", "--solver", "jacobi", "--early-exit"]
    ))
    assert cfg5.solver == "jacobi" and cfg5.early_exit

    # --residual-metric validates at parse time (like --effect) and is
    # case-insensitive.
    assert parse_args(["--residual-metric", "MAX"]).residual_metric == "max"
    with pytest.raises(SystemExit, match="residual-metric"):
        parse_args(["--residual-metric", "rsm"])

    # --gray-pyramid validates at parse time too (a typo must not surface
    # as a trace-time traceback) and is case-insensitive.
    assert parse_args(["--gray-pyramid", "OpenCV"]).gray_pyramid == "opencv"
    with pytest.raises(SystemExit, match="gray-pyramid"):
        parse_args(["--gray-pyramid", "opencV2"])

    # Red-black SOR tuning is argv-reachable too.
    cfg4 = make_config(parse_args([
        "-i", "x.jpg", "--solver", "red_black", "--rb-rho", "0.995",
    ]))
    assert cfg4.rb_rho == pytest.approx(0.995)
    assert cfg4.rb_chebyshev is True
    cfg5 = make_config(parse_args(["-i", "x.jpg", "--rb-plain"]))
    assert cfg5.rb_chebyshev is False
    with pytest.raises(SystemExit, match="number"):
        parse_args(["--rb-rho", "abc"])


def test_cli_profile_flag():
    """--profile fast = red_black + RMS early exit @1e-3 + the incremental
    live path; faithful = the defaults; explicit flags override."""
    from realtimedepthdiffusion.live.cli import make_config

    cfg = make_config(parse_args(["-i", "x.jpg", "--profile", "fast"]))
    assert cfg.solver == "red_black" and cfg.early_exit
    assert cfg.tolerance == pytest.approx(1e-3)
    assert cfg.residual_metric == "rms"
    assert cfg.incremental_iterations == 120

    assert make_config(
        parse_args(["-i", "x.jpg", "--profile", "faithful"])
    ) == DiffusionConfig()

    # explicit flags override the profile's choices
    cfg = make_config(parse_args(
        ["-i", "x.jpg", "--profile", "fast", "--tolerance", "1e-4",
         "--incremental", "0"]
    ))
    assert cfg.tolerance == pytest.approx(1e-4)
    assert cfg.incremental_iterations == 0
    # overriding the solver away from red_black KEEPS the profile's early
    # exit: every solver honors the tolerance now (round 5)
    cfg = make_config(parse_args(
        ["-i", "x.jpg", "--profile", "fast", "--solver", "jacobi_chebyshev"]
    ))
    assert cfg.solver == "jacobi_chebyshev" and cfg.early_exit

    with pytest.raises(SystemExit, match="profile"):
        parse_args(["--profile", "turbo"])


def test_gui_live_incremental_hits_windowed_path(monkeypatch):
    """--live --incremental: after the first full solve, a small paint stroke
    must take the windowed incremental re-solve (pipe.solve_incremental), and
    idle live frames (no dirty rect) must not (they reuse the device
    annotation and run the cheap warm full re-solve)."""
    from realtimedepthdiffusion.live.gui import handle_key

    rgb, _, _ = synthetic_pair(96, 96, 3)
    cfg = DiffusionConfig(max_iterations=20, incremental_iterations=8,
                          incremental_window=32)
    s = DepthSession(rgb, cfg)

    local_calls = []
    real = s.pipe.solve_incremental
    monkeypatch.setattr(
        s.pipe, "solve_incremental",
        lambda *a, **kw: (local_calls.append(1), real(*a, **kw))[1],
    )

    s.set_color_key(4)
    s.paint(20, 20)
    handle_key(s, ord("d"))  # first solve is always the full schedule
    assert s.solve_count == 1 and not local_calls

    s.paint(48, 48)  # small stroke -> dirty rect fits the window
    handle_key(s, 255, live=True)
    assert s.solve_count == 2
    assert len(local_calls) == 1, "small edit did not take the windowed path"

    handle_key(s, 255, live=True)  # idle live frame: no edit, no local solve
    assert s.solve_count == 3 and len(local_calls) == 1


def test_cli_defocus_quality_flags():
    """--defocus-quality/--defocus-stride reach the config (the 4K latency
    lever must be argv-reachable like every other behavior knob); a stride
    alone implies approx; parse-time validation."""
    import pytest

    from realtimedepthdiffusion.live.cli import make_config, parse_args

    cfg = make_config(parse_args(["-i", "x.jpg", "--defocus-quality", "approx"]))
    assert cfg.pallas_defocus_quality == "approx"
    assert cfg.pallas_defocus_stride == 4  # the measured default

    cfg2 = make_config(parse_args(["-i", "x.jpg", "--defocus-stride", "8"]))
    assert cfg2.pallas_defocus_quality == "approx"
    assert cfg2.pallas_defocus_stride == 8

    # Explicit exact pins quality even with a stride present (inert knob).
    cfg3 = make_config(parse_args(
        ["-i", "x.jpg", "--defocus-quality", "EXACT", "--defocus-stride", "8"]
    ))
    assert cfg3.pallas_defocus_quality == "exact"

    # Default (round 5): 'auto' — exact at every <=1440p aperture (the
    # reference-faithful path where exactness is the contract), bounded
    # -error approx at 4K+ (loudly reported).
    assert make_config(parse_args(["-i", "x.jpg"])).pallas_defocus_quality == "auto"
    # And 'auto' is an accepted explicit value.
    cfg4 = make_config(parse_args(["-i", "x.jpg", "--defocus-quality", "auto"]))
    assert cfg4.pallas_defocus_quality == "auto"

    with pytest.raises(SystemExit, match="defocus-quality"):
        parse_args(["--defocus-quality", "fast"])
    with pytest.raises(SystemExit, match="integer"):
        parse_args(["--defocus-stride", "abc"])
    with pytest.raises(SystemExit, match=">= 2"):
        parse_args(["--defocus-stride", "1"])


def test_serve_defocus_quality_flags():
    """rtdd-serve's config resolution honors the defocus-quality knobs with
    the same rules as the live CLI."""
    import argparse

    import pytest

    from realtimedepthdiffusion import serve as serve_mod

    def parse(args):
        # Reuse main()'s parser by capturing the resolved config.
        p = argparse.ArgumentParser()
        captured = {}
        real = serve_mod.config_from_args

        def capture(a, error=None):
            cfg = real(a, error)
            captured["cfg"] = cfg
            raise SystemExit(0)  # stop before any solving

        serve_mod.config_from_args = capture
        try:
            with pytest.raises(SystemExit):
                serve_mod.main(args + ["--out", "/tmp/x"])
        finally:
            serve_mod.config_from_args = real
        return captured.get("cfg")  # None if rejected before resolving

    cfg = parse(["--defocus-quality", "approx"])
    assert cfg.pallas_defocus_quality == "approx"
    cfg2 = parse(["--defocus-stride", "6"])
    assert cfg2.pallas_defocus_quality == "approx"
    assert cfg2.pallas_defocus_stride == 6
    cfg3 = parse(["--defocus-quality", "exact", "--defocus-stride", "6"])
    assert cfg3.pallas_defocus_quality == "exact"
    # stride 1 is rejected by argparse .error before any config resolves
    assert parse(["--defocus-stride", "1"]) is None
