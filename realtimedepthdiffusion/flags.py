"""Shared solver-flag resolution for every CLI surface.

`depth-diffusion` (live/cli.py), `rtdd-serve` (serve.py) and `rtdd-warmup`
(warmup.py, via serve.config_from_args) expose the same solver behavior
surface from argv — profiles, early exit, SOR tuning, defocus quality.
The implication rules (a profile sets a base the explicit flags override;
--tolerance implies --early-exit; --defocus-stride implies approx
quality) must be identical everywhere, so
they live here once; each CLI layers only its surface-specific extras
(the live CLI's --incremental/--gray-pyramid, serving's --iterations) on
top of the returned kwargs.
"""

from __future__ import annotations

from typing import Callable, Dict


def resolve_solver_flags(a, fail: Callable[[str], None]) -> Dict:
    """Resolve the shared solver flags of a parsed-args namespace into
    DiffusionConfig kwargs.

    ``a`` needs: backend, solver, tolerance, residual_metric, rb_rho,
    rb_plain, defocus_quality, defocus_stride; optionally profile,
    multigrid, early_exit. ``fail(msg)`` must not return (argparse
    ``error``, SystemExit, or ValueError — each surface keeps its own
    error style).

    Rules (each cited to the surface that earned it):
    - ``--profile fast`` = red_black + RMS early exit at 1e-3, the
      configuration that reaches the quality bar in the fewest sweeps (CPU
      ledger, PERF.md); explicit flags override the profile's choices. An explicit
      --solver override KEEPS the profile's early exit — every solver
      honors the tolerance (round-5; previously only red_black did).
    - A --tolerance given without --early-exit means "use it": the
      reference accepts a tolerance it never honors
      (/root/reference/src/main.cpp:264); this framework honors it when
      asked.
    - A --defocus-stride given without --defocus-quality means "use it"
      (same rule) — unless quality was explicitly pinned to exact.
    """
    kw: Dict = {"backend": a.backend}
    fast = getattr(a, "profile", None) == "fast"
    solver = a.solver if a.solver is not None else (
        "red_black" if fast else "jacobi_chebyshev"
    )
    kw["solver"] = solver
    if fast:
        kw["tolerance"] = 1e-3
        kw["residual_metric"] = "rms"
        kw["early_exit"] = True
    mg = getattr(a, "multigrid", None)
    if mg is not None:
        kw["multigrid"] = mg
    if getattr(a, "early_exit", False):
        kw["early_exit"] = True
    if a.tolerance is not None:
        kw["tolerance"] = a.tolerance
        kw["early_exit"] = True
    if a.residual_metric is not None:
        kw["residual_metric"] = a.residual_metric
    if a.rb_rho is not None:
        kw["rb_rho"] = a.rb_rho
    if a.rb_plain:
        kw["rb_chebyshev"] = False
    if a.defocus_quality is not None:
        kw["pallas_defocus_quality"] = a.defocus_quality
    if a.defocus_stride is not None:
        if a.defocus_stride < 2:
            fail(
                "--defocus-stride must be >= 2 (1 is the exact kernel; use "
                "--defocus-quality exact)"
            )
        kw["pallas_defocus_stride"] = a.defocus_stride
        kw.setdefault("pallas_defocus_quality", "approx")
    return kw
