"""Configuration for the depth-diffusion framework.

Every algorithm constant that is hard-coded in the reference implementation is a
first-class, documented field here, defaulted to the reference value (citations
point into /root/reference):

- ``beta`` / ``max_iterations``:      src/main.cpp:152-153
- ``tolerance``:                      src/main.cpp:264 (declared but unused in the
                                      reference; honored here when
                                      ``early_exit=True``)
- ``chebyshev_s/rho/gamma``:          src/GPUSolver.cu:282-285
- ``pyramid_base_size``:              src/main.cpp:95  (the ``/45`` in the level
                                      count formula)
- ``depth_edge_threshold``:           src/GPUSolver.cu:201-202
- ``brush_fraction``:                 src/main.cpp:154 (2% of min dimension)
- ``haze_beta``:                      src/GPUDepthEffect.cu:87
- ``defocus_aperture``:               src/GPUDepthEffect.cu:42 (0.025 * diagonal)
- ``annotation_sentinel``:            src/main.cpp:163 (gray value 32 =
                                      unannotated)
- ``depth_init``:                     src/main.cpp:109,136 (255 = far)
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple


# The canonical early-exit residual metrics (core/solver.residual_metric_fn
# maps them to functionals; the CLI validates against the same tuple).
VALID_RESIDUAL_METRICS = ("rms", "max")


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """All tunables of the depth-diffusion pipeline.

    Defaults reproduce the reference behavior exactly.
    """

    # --- Edge-weight model (src/GPUSolver.cu:264-272, src/main.cpp:152) ---
    beta: float = 0.4

    # --- Iteration schedule (src/main.cpp:153,263) ---
    max_iterations: int = 1000

    # --- Chebyshev semi-iteration (src/GPUSolver.cu:282-285) ---
    chebyshev_s: int = 10
    chebyshev_rho: float = 0.99
    chebyshev_gamma: float = 0.99

    # --- Pyramid geometry (src/main.cpp:95,103) ---
    pyramid_base_size: int = 45
    # Gray-chain convention: "opencv" (default) reproduces the binary's
    # actual numerics — a ceil-size cv::pyrDown chain consumed cropped to the
    # floor-size solver buffers (bug #1's always-taken CPU fallback,
    # src/main.cpp:241-247 + the rows/cols-vs-pitch mismatch at :266-268);
    # "floor" chains at floor sizes (single clean convention, differs near
    # odd-level borders).
    gray_pyramid: str = "opencv"

    # --- Level-dependent edge rule (src/GPUSolver.cu:201-202) ---
    depth_edge_threshold: int = 4  # 0 is forced at level 0 by the solver

    # --- Convergence control (reference declares tol but never uses it,
    #     src/main.cpp:264; we implement it as an opt-in feature honored by
    #     EVERY solver — jacobi_chebyshev, jacobi, and red_black each run a
    #     chunked residual loop when early_exit is on) ---
    tolerance: float = 1e-5
    early_exit: bool = False
    # Residual check cadence when early_exit is on (sweeps between checks).
    residual_check_every: int = 25
    # Early-exit residual metric, threshold tolerance*255 either way:
    #   "rms" — root-mean-square of |relax(u) - u| over non-scribble pixels.
    #           The metric that can actually fire at fine levels: the
    #           max-norm is pinned at tens of gray levels by a handful of
    #           stubborn weak-edge pixels even after the FULL iteration cap
    #           (measured on Flower L0: max 31.9 vs rms 0.11 at the cap —
    #           PERF.md round-3), so a max-norm exit silently degenerates to
    #           fixed-count exactly where the time is spent.
    #   "max" — max-norm (the round-2 semantics), strictly conservative.
    residual_metric: str = "rms"

    # --- Solver variant: "jacobi_chebyshev" (reference), "jacobi",
    #     "red_black" (red-black Gauss-Seidel, BASELINE.json config #2) ---
    solver: str = "jacobi_chebyshev"
    # Cyclic-Chebyshev (Golub-Varga) SOR omegas on the red-black half-sweeps
    # (core.solver.rb_omegas): ~2x the per-iteration convergence of the
    # reference's Chebyshev-Jacobi, which is what lets config #2's residual
    # early exit stop in fewer sweeps (CPU ledger, PERF.md). False = plain
    # Gauss-Seidel
    # (the round-2 formulation). Reuses chebyshev_s for the warm-up.
    rb_chebyshev: bool = True
    # Spectral-radius estimate for the red-black schedule. The reference's
    # 0.99 (chebyshev_rho) badly UNDERESTIMATES real image grids, which is
    # fatal for Chebyshev acceleration (the polynomial blows up outside its
    # design interval); overestimating only costs a mild transient. 0.9999
    # measured best on the dataset cascade (round-3 sweep: beats both 0.99
    # and per-level cos(pi/N) on quality and on sweeps to the exit).
    rb_rho: float = 0.9999

    # --- Multigrid scheme: "cascadic" (reference one-way coarse-to-fine) or
    #     "vcycle" (full V-cycle, BASELINE.json config #4) ---
    multigrid: str = "cascadic"
    # Fraction of max_iterations used by the cascadic warm start before the
    # V-cycles (1.0 = full cascade + polishing cycles; lower values shift
    # work from the cascade onto the cycles).
    vcycle_warm_fraction: float = 1.0
    vcycle_pre_smooth: int = 8
    vcycle_post_smooth: int = 8
    vcycle_coarse_iters: int = 200
    vcycles: int = 2

    # --- Annotation / interaction contract (src/main.cpp:41-43,154,163) ---
    annotation_sentinel: int = 32
    depth_init: float = 255.0
    brush_fraction: float = 0.02

    # --- Effects (src/GPUDepthEffect.cu:42,87) ---
    haze_beta: float = 2.0
    defocus_aperture: float = 0.025
    haze_airlight: float = 255.0

    # --- Incremental/live solve: iteration budget for warm-started re-solves
    #     after small edits (0 = always the full schedule, reference parity).
    #     The live loop's first solve always uses the full budget. ---
    incremental_iterations: int = 0
    # Window side (pixels at level 0, halved per level) for the localized
    # incremental re-solve around the dirty rect; levels whose whole extent
    # fits the scaled window take a full warm re-solve instead.
    incremental_window: int = 384
    # Number of FINE pyramid levels that take the windowed re-solve; all
    # coarser levels re-solve fully (they are small, and carry the edit's
    # whole far field).
    incremental_window_levels: int = 2
    # Maximum simultaneous dirty rects kept separate by the live session
    # (live/session.py): up to this many distant strokes each take the
    # windowed incremental path sequentially (one compiled window program,
    # different centers); overflow merges the nearest rects toward the old
    # single-bounding-rect behavior.
    incremental_max_rects: int = 4
    # Global sweeps per windowed level that polish the injected coarse
    # correction along image edges before the deep window solve. The round-4
    # 39-case ledger (tools/incremental_report.py; PERF.md "Incremental live
    # path") measured worst-case RMSE vs a full re-solve of 0.0262 at gs=0
    # vs 0.0256 at gs=2 — a 2% worst-case gain, localized to three pairs —
    # while each global sweep is a full-plane kernel launch on the
    # latency-critical live path. Off by default; raise for maximum
    # far-field fidelity.
    incremental_global_smooth: int = 0

    # --- Backend selection (ops/dispatch.py route table): "auto" takes the
    #     coarse-level GPU kernel where it applies and XLA elsewhere; "xla";
    #     "pallas" (the kernel, raising where the platform has none);
    #     "pallas_interpret" (the kernel under the Pallas interpreter) ---
    backend: str = "auto"
    # Cold-start strategy: serve the FIRST solve(s) from per-level staged
    # programs (small XLA modules that compile in parallel) while the fused
    # whole-cascade program — numerically identical,
    # tests/test_fast_start.py — compiles on a background thread. Once the
    # fused executable lands, solves switch to it (one dispatch per frame).
    # Off: the first solve blocks on the fused compile (round-3 behavior).
    # The V-cycle scheme has no staged form and always takes the fused path.
    # Default: on, overridable process-wide with RTDD_FAST_START=0 (the test
    # suite pins it off so routing is deterministic and no background
    # compile competes with the single test CPU).
    fast_start: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "RTDD_FAST_START", "1"
        ).lower() not in ("0", "false")
    )

    # --- Defocus quality/latency tradeoff (the 4K lever). The exact blur
    #     marches every window half-width candidate (max_half 55 at 4K);
    #     "approx" SNAPS each pixel's half-width to a subsampled candidate
    #     set — every half up to pallas_defocus_exact_upto stays exact,
    #     larger halves round to the nearest multiple of
    #     pallas_defocus_stride above it — so the march skips the
    #     non-candidates. The output is EXACTLY the defocus of the snapped
    #     half field, so the error is bounded by half a stride of window
    #     growth on already-large (>= exact_upto) blur windows; near-focus
    #     detail is untouched. Every defocus caller snaps identically.
    #     Error ledger: tools/defocus_quality_report.py + PERF.md.
    #
    #     "auto" (default): exact while max_half <=
    #     pallas_defocus_auto_max_half (every <=1440p-class geometry, incl.
    #     all dataset pairs and the 1080p headline), bounded-error approx
    #     above it (4K+), announced with a loud one-time warning
    #     (core/effects.resolved_defocus_quality). ---
    pallas_defocus_quality: str = "auto"
    pallas_defocus_exact_upto: int = 16
    pallas_defocus_stride: int = 4
    # 'auto' threshold: largest aperture max_half served exactly. 40 covers
    # 1600x2844 (diag ~3265, k 81) and below; the 4K regime (max_half 55)
    # resolves to approx.
    pallas_defocus_auto_max_half: int = 40

    def __post_init__(self):
        # Validate at construction so EVERY surface (library, serving, CLI)
        # fails loudly instead of silently ignoring the request — the
        # reference accepts a tolerance it never honors (src/main.cpp:264);
        # this framework refuses to reproduce that bug.
        if self.residual_metric not in VALID_RESIDUAL_METRICS:
            raise ValueError(
                f"unknown residual_metric {self.residual_metric!r}; "
                f"expected one of {VALID_RESIDUAL_METRICS}"
            )
        if self.pallas_defocus_quality not in ("auto", "exact", "approx"):
            raise ValueError(
                f"unknown pallas_defocus_quality "
                f"{self.pallas_defocus_quality!r}; expected 'auto', 'exact' "
                f"or 'approx'"
            )
        if self.pallas_defocus_quality in ("auto", "approx"):
            # auto can resolve to approx, so its knobs validate too
            if self.pallas_defocus_exact_upto < 1:
                raise ValueError(
                    "pallas_defocus_exact_upto must be >= 1 (half-widths up "
                    f"to it stay exact); got {self.pallas_defocus_exact_upto}"
                )
            if self.pallas_defocus_stride < 2:
                raise ValueError(
                    "pallas_defocus_stride must be >= 2 (1 is the exact "
                    f"kernel); got {self.pallas_defocus_stride}"
                )

    def num_levels(self, rows: int, cols: int) -> int:
        """Pyramid depth: log2(max(min(W,H)/base,1))+1 (src/main.cpp:95).

        Matches C's int truncation of ``log2`` applied to the *integer*
        quotient min(W,H)/45.
        """
        q = max(min(rows, cols) // self.pyramid_base_size, 1)
        return int(math.log2(q)) + 1

    def level_size(self, rows: int, cols: int, level: int) -> Tuple[int, int]:
        """Per-level size with floor division (src/main.cpp:103).

        The reference mixes floor (its own buffers) and ceil (OpenCV) pyramid
        conventions — quirk #7 in SURVEY.md. This framework owns a single
        convention: floor everywhere.
        """
        return rows >> level, cols >> level

    def level_iterations(self, num_levels: int, level: int) -> int:
        """iters = max_iterations / 2^((L-1)-level), truncated
        (src/main.cpp:263): 1000, 500, 250, 125, 62 ... coarse-to-fine."""
        return int(self.max_iterations / (2.0 ** ((num_levels - 1) - level)))

    def brush_radius(self, rows: int, cols: int) -> int:
        """Initial scribble brush side (src/main.cpp:154)."""
        return int(min(rows, cols) * self.brush_fraction)

    def defocus_kernel_size(self, rows: int, cols: int) -> int:
        """Max defocus window: 0.025 * image diagonal (src/GPUDepthEffect.cu:42)."""
        return int(self.defocus_aperture * math.sqrt(rows * rows + cols * cols))


DEFAULT_CONFIG = DiffusionConfig()

# The five discrete scribble depth values selectable with keys '0'..'4'
# (src/main.cpp:41-43): min((key-'0')*64, 254).
SCRIBBLE_DEPTH_VALUES = (0, 64, 128, 192, 254)
