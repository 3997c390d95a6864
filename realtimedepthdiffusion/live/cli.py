"""CLI — preserves the reference's argument contract (src/main.cpp:64-90):

    depth-diffusion -i <image> [-a <annotation>] [--live] [-h]

plus headless extensions for CI/scripting (the reference is GUI-only):

    --headless         run without windows
    --solve            perform one solve (headless)
    --effect b|g|h     render an effect after solving (headless);
                       long names refocus/desaturation/haze also accepted
    --save-dir DIR     write AnnotatedImage/DepthMap/ArtisticEffect PNGs
    --backend ...      auto | xla | pallas (default auto: the coarse-level
                       GPU kernel where it applies, XLA elsewhere)
    --profile ...      faithful | fast — named solver profile (fast =
                       red_black + RMS early exit @1e-3 + incremental live
                       path; explicit flags override the profile)
    --solver ...       jacobi_chebyshev | jacobi | red_black
    --multigrid ...    cascadic | vcycle
    --incremental N    windowed warm re-solve with N iterations after small
                       edits (the low-latency --live painting path)
    --early-exit       stop a level once the residual drops below tolerance
                       (every solver honors it; the reference declares a
                       tolerance and ignores it, src/main.cpp:264)
    --tolerance X      residual tolerance for --early-exit (default 1e-5,
                       the value the reference declares but never uses)
    --residual-metric  rms | max — early-exit residual functional (default
                       rms; max-norm cannot fire at fine levels, PERF.md)
    --rb-rho X         spectral-radius estimate for the red-black
                       cyclic-Chebyshev omegas (default 0.9999)
    --rb-plain         plain Gauss-Seidel red-black (disable the SOR omegas)
    --gray-pyramid ... opencv | floor (gray-chain convention)
    --defocus-quality  auto | exact | approx — refocus window-half set.
                       auto (default): exact through ~1440p apertures,
                       bounded-error approx at 4K+ (loudly reported);
                       approx snaps blur windows larger than 16 px to a
                       stride grid (bounded error, ~2x fewer marched
                       candidates at 4K — the 4K latency lever, PERF.md)
    --defocus-stride N approx candidate stride (default 4; implies
                       --defocus-quality approx)
    --depth16          also save DepthMap16.png (16-bit PNG at the solver's
                       full precision; the 8-bit map quantizes away the
                       converged sub-gray signal)
    --time             print the timing report after solving

Run as ``python -m realtimedepthdiffusion.live.cli``. The whole behavior
surface of the framework is reachable from argv, like the reference's
(src/main.cpp:81-90 + its key bindings).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

from ..config import VALID_RESIDUAL_METRICS, DiffusionConfig
from ..io import imread_rgb

USAGE_SHORT = "Usage: depth-diffusion -i ImageFile.Extension"

# --effect accepts the GUI key letters plus their long names.
_EFFECT_NAMES = {
    "b": "b", "refocus": "b", "defocus": "b",
    "g": "g", "grayscale": "g", "desaturation": "g", "desaturate": "g",
    "h": "h", "haze": "h",
}
USAGE = (
    "Usage:\n -i input image\n -a annotated image\n --live solve every frame\n"
    " --headless run without GUI\n --solve run one solve (headless)\n"
    " --effect b|g|h (refocus|desaturation|haze) artistic effect\n --save-dir DIR output directory\n"
    " --checkpoint F save full session state\n --resume F restore session state\n --backend auto|xla|pallas\n --profile faithful|fast named solver profile\n --solver jacobi_chebyshev|jacobi|red_black\n"
    " --multigrid cascadic|vcycle\n --incremental N windowed live re-solve budget\n"
    " --early-exit residual-tolerance early exit (any solver)\n --tolerance X residual tolerance (default 1e-5)\n"
    " --residual-metric rms|max early-exit residual functional (default rms)\n"
    " --rb-rho X red-black Chebyshev rho (default 0.9999)\n --rb-plain disable red-black SOR omegas\n"
    " --gray-pyramid opencv|floor gray-chain convention\n"
    " --defocus-quality auto|exact|approx refocus window-half set (auto =\n"
    "   exact through ~1440p, bounded-error approx at 4K+, loudly reported)\n"
    " --defocus-stride N approx candidate stride (default 4)\n"
    " --depth16 also save a 16-bit DepthMap16.png\n --time print timing report\n"
    " --trace DIR dump a jax.profiler trace of the solve\n --verbose debug logging\n"
)


@dataclasses.dataclass
class CliArgs:
    image: Optional[str] = None
    annotation: Optional[str] = None
    live: bool = False
    headless: bool = False
    solve: bool = False
    effect: Optional[str] = None
    save_dir: Optional[str] = None
    checkpoint: Optional[str] = None
    resume: Optional[str] = None
    show_time: bool = False
    trace_dir: Optional[str] = None
    verbose: bool = False
    backend: str = "auto"
    profile: Optional[str] = None
    solver: Optional[str] = None  # None -> profile choice or jacobi_chebyshev
    multigrid: str = "cascadic"
    incremental: Optional[int] = None  # None -> profile choice or 0
    early_exit: bool = False
    tolerance: Optional[float] = None
    residual_metric: Optional[str] = None
    rb_rho: Optional[float] = None
    rb_plain: bool = False
    gray_pyramid: str = "opencv"
    depth16: bool = False
    defocus_quality: Optional[str] = None  # None -> 'auto' (the default)
    defocus_stride: Optional[int] = None
    help: bool = False


def parse_args(argv: List[str]) -> CliArgs:
    """Hand-rolled to preserve the reference's loose parsing (flags may
    appear in any order; unknown flags are ignored, src/main.cpp:81-90)."""
    a = CliArgs()
    i = 0
    while i < len(argv):
        arg = argv[i]

        def val() -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                raise SystemExit(f"error: {arg} requires a value\n{USAGE}")
            return argv[i]

        if arg == "-i":
            a.image = val()
        elif arg == "-a":
            a.annotation = val()
        elif arg == "--live":
            a.live = True
        elif arg == "--headless":
            a.headless = True
        elif arg == "--solve":
            a.solve = True
        elif arg == "--effect":
            # Accept the reference's key letters (src/main.cpp:190-230) and
            # their long names; reject anything else loudly — a silently
            # ignored effect saves the reference's all-zeros ArtisticEffect
            # (main.cpp:94,314-316), which reads as a broken run.
            v = val().lower()
            a.effect = _EFFECT_NAMES.get(v)
            if a.effect is None:
                raise SystemExit(
                    f"error: unknown --effect {v!r} "
                    f"(choose from {sorted(_EFFECT_NAMES)})\n{USAGE}"
                )
        elif arg == "--save-dir":
            a.save_dir = val()
        elif arg == "--checkpoint":
            a.checkpoint = val()
        elif arg == "--resume":
            a.resume = val()
        elif arg == "--time":
            a.show_time = True
        elif arg == "--trace":
            a.trace_dir = val()
        elif arg == "--verbose":
            a.verbose = True
        elif arg == "--backend":
            a.backend = val()
        elif arg == "--profile":
            v = val().lower()
            if v not in ("faithful", "fast"):
                raise SystemExit(
                    f"error: unknown --profile {v!r} "
                    f"(choose from ['faithful', 'fast'])\n{USAGE}"
                )
            a.profile = v
        elif arg == "--solver":
            a.solver = val()
        elif arg == "--multigrid":
            a.multigrid = val()
        elif arg == "--incremental":
            try:
                a.incremental = int(val())
            except ValueError:
                raise SystemExit(f"error: --incremental expects an integer\n{USAGE}")
        elif arg == "--early-exit":
            a.early_exit = True
        elif arg == "--tolerance":
            try:
                a.tolerance = float(val())
            except ValueError:
                raise SystemExit(f"error: --tolerance expects a number\n{USAGE}")
        elif arg == "--residual-metric":
            # Validate at parse time like --effect: a typo'd metric would
            # otherwise surface as a trace-time ValueError (or be silently
            # ignored when no early-exit path consumes it).
            v = val().lower()
            if v not in VALID_RESIDUAL_METRICS:
                raise SystemExit(
                    f"error: unknown --residual-metric {v!r} "
                    f"(choose from {sorted(VALID_RESIDUAL_METRICS)})\n{USAGE}"
                )
            a.residual_metric = v
        elif arg == "--rb-rho":
            try:
                a.rb_rho = float(val())
            except ValueError:
                raise SystemExit(f"error: --rb-rho expects a number\n{USAGE}")
        elif arg == "--rb-plain":
            a.rb_plain = True
        elif arg == "--gray-pyramid":
            # Parse-time validation like --effect/--residual-metric: a typo
            # would otherwise only fail at trace time inside
            # core/multigrid.build_gray_pyramid with a raw traceback.
            v = val().lower()
            if v not in ("opencv", "floor"):
                raise SystemExit(
                    f"error: unknown --gray-pyramid {v!r} "
                    f"(choose from ['floor', 'opencv'])\n{USAGE}"
                )
            a.gray_pyramid = v
        elif arg == "--depth16":
            a.depth16 = True
        elif arg == "--defocus-quality":
            # Parse-time validation like --effect/--residual-metric.
            v = val().lower()
            if v not in ("auto", "exact", "approx"):
                raise SystemExit(
                    f"error: unknown --defocus-quality {v!r} "
                    f"(choose from ['auto', 'exact', 'approx'])\n{USAGE}"
                )
            a.defocus_quality = v
        elif arg == "--defocus-stride":
            try:
                a.defocus_stride = int(val())
            except ValueError:
                raise SystemExit(
                    f"error: --defocus-stride expects an integer\n{USAGE}"
                )
            if a.defocus_stride < 2:
                raise SystemExit(
                    "error: --defocus-stride must be >= 2 (1 is the exact "
                    f"kernel; use --defocus-quality exact)\n{USAGE}"
                )
        elif arg == "-h" or arg == "--help":
            a.help = True
        i += 1
    return a


def make_config(a: CliArgs) -> DiffusionConfig:
    """Every solver-facing flag lands in the config — the whole behavior
    surface (incremental live path, early exit, gray-chain convention) is
    reachable from argv, not only programmatically.

    ``--profile fast`` sets a base (red_black + RMS early exit at 1e-3 +
    the 120-iteration incremental live path — the fewest sweeps to the
    quality bar, CPU ledger in PERF.md); explicit flags override
    the profile's choices. ``--profile faithful`` (and no profile) keeps
    the reference-faithful defaults."""
    from ..flags import resolve_solver_flags

    def fail(msg: str):
        # This CLI's error style: message + the usage block, exit 2 via
        # SystemExit (matching the reference's print-usage-and-exit).
        raise SystemExit(f"error: {msg}\n{USAGE}")

    kw = resolve_solver_flags(a, fail)
    # Live-CLI-only extras on top of the shared surface:
    incremental = a.incremental if a.incremental is not None else (
        120 if a.profile == "fast" else 0
    )
    kw["incremental_iterations"] = max(int(incremental), 0)
    kw["gray_pyramid"] = a.gray_pyramid
    return DiffusionConfig(**kw)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(USAGE_SHORT)
        return 0
    a = parse_args(argv)
    if a.help:
        print(USAGE)
        if a.image is None:
            return 0
    if a.image is None:
        print(USAGE_SHORT)
        return 0
    # Persistent XLA cache: after the first run on a given image shape the
    # tool starts in seconds, like the reference's precompiled CUDA binary.
    # (After the help/no-image returns — those paths must not import jax.)
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if a.verbose:
        import logging

        logging.basicConfig(level=logging.DEBUG, format="%(name)s %(message)s")

    from .session import DepthSession  # defer jax import until needed

    rgb = imread_rgb(a.image)
    session = DepthSession(rgb, make_config(a))
    session.save_depth16 = a.depth16
    if a.annotation:
        session.load_annotation_file(a.annotation)
    if a.resume:
        session.load_checkpoint(a.resume)
    if a.effect:
        session.set_effect_key(a.effect)

    if a.headless:
        if not a.live:
            # One-shot process: it exits right after the solve, so a
            # background fused compile could never serve a frame — don't
            # start one (the staged fast-start path does the work; an
            # orphaned compile would only load the compile service).
            session.pipe.background_compile = False
            if session._inc_pipe is not None:
                session._inc_pipe.background_compile = False
        if a.solve or a.live or a.effect:
            if a.trace_dir:
                from ..utils.timing import device_trace

                with device_trace(a.trace_dir):
                    session.solve()
                print(f"Profiler trace written to {a.trace_dir}")
            else:
                session.solve()
            if a.show_time:
                print(session.timing_report())
                print(session.residual_report())
        if a.save_dir:
            paths = session.save(a.save_dir, depth16=a.depth16)
            print("Saving images...")
            for p in paths:
                print(f"  {p}")
        if a.checkpoint:
            session.save_checkpoint(a.checkpoint)
            print(f"Checkpoint saved: {a.checkpoint}")
        return 0

    from .gui import run_gui  # imports cv2 (I/O boundary)

    return run_gui(session, live=a.live)


if __name__ == "__main__":
    raise SystemExit(main())
