"""Route table for the per-level solve.

``route(platform, op, solver, backend, early_exit)`` names the path one
operation takes; every caller that could take a kernel consults it
(core.multigrid and core.incremental through ``solve_level``, and
parallel.sharded).

Operations:

- ``level``    one pyramid level's sweeps on one device. Kernel: the
               coarse-level sweep kernel (ops.coarse_sweep), on ``gpu``, for
               the fixed-count ``jacobi_chebyshev`` solver, on levels that
               fit one CTA (``coarse_sweep.fits``).
- ``sharded``  the in-shard sweep blocks of the multi-device solve
               (parallel.sharded). No kernel on any platform.

Backends:

- ``xla``              XLA everywhere.
- ``auto``             the kernel where it applies, XLA elsewhere.
- ``pallas``           as ``auto``, but a platform without the operation's
                       kernel raises ``ValueError`` instead of falling back.
- ``pallas_interpret`` the kernel under the Pallas interpreter where it
                       applies (CPU tests of the kernel); raises where the
                       operation has no kernel.

Routes: ``"xla"``, ``"kernel"`` or ``"interpret"``.
"""

from __future__ import annotations

import jax

from ..config import DiffusionConfig
from ..core import solver as _xla_solver

VALID_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")
# Platforms with a kernel, per operation, and the solver the kernel runs.
KERNEL_PLATFORMS = {"level": ("gpu",), "sharded": ()}
KERNEL_SOLVER = "jacobi_chebyshev"


def route(platform: str, op: str, solver: str, backend: str,
          early_exit: bool = False) -> str:
    """The path ``op`` takes for (platform, solver, backend); see the module
    docstring."""
    if backend not in VALID_BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {VALID_BACKENDS}"
        )
    platforms = KERNEL_PLATFORMS[op]
    if backend == "xla":
        return "xla"
    if backend == "pallas" and platform not in platforms:
        raise ValueError(
            f"backend='pallas': no {op!r} kernel on platform {platform!r} "
            f"(kernels exist on {platforms or 'no platform'}); use 'auto' or "
            f"'xla'"
        )
    if backend == "pallas_interpret" and not platforms:
        raise ValueError(
            f"backend='pallas_interpret': the {op!r} operation has no kernel "
            f"to interpret; use 'auto' or 'xla'"
        )
    if solver != KERNEL_SOLVER or early_exit:
        return "xla"
    if backend == "pallas_interpret":
        return "interpret"
    return "kernel" if platform in platforms else "xla"


def solve_level(depth, mask, gray, level, max_level, iters, cfg: DiffusionConfig):
    """Per-level solve along ``route(..., 'level', ...)``; the kernel takes
    only levels that fit one CTA, larger ones stay on XLA."""
    r = route(jax.default_backend(), "level", cfg.solver, cfg.backend,
              cfg.early_exit)
    if r != "xla":
        from . import coarse_sweep

        if coarse_sweep.fits(*depth.shape):
            return coarse_sweep.solve_level(
                depth, mask, gray, level, max_level, iters, cfg,
                interpret=(r == "interpret"),
            )
    return _xla_solver.solve_level(depth, mask, gray, level, max_level, iters, cfg)
