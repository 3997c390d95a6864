"""Device-mesh construction for multi-chip solves.

The reference is strictly single-GPU (SURVEY.md §2: no DP/TP/PP, no NCCL);
this module provides the framework's scale-out axis instead: a
('batch', 'dy', 'dx') mesh where 'batch' is data parallelism over images and
('dy','dx') is 2-D spatial sharding of each image — the stencil analog of
sequence/context parallelism. All communication is XLA collectives
(ppermute halo exchange, psum reductions), which XLA hands to NCCL on GPUs;
there is no external transport.
"""

from __future__ import annotations

from typing import Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def factor3(n: int) -> Tuple[int, int, int]:
    """Factor n devices into (batch, dy, dx), preferring spatial axes and
    near-square spatial tiles: 8 -> (2,2,2), 4 -> (1,2,2), 2 -> (1,1,2),
    1 -> (1,1,1), 6 -> (1,2,3)... Any composite n is supported."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")

    def best_2d(m: int) -> Tuple[int, int]:
        a = int(np.sqrt(m))
        while a > 1 and m % a:
            a -= 1
        return (max(a, 1), m // max(a, 1))

    dy, dx = best_2d(n)
    if dy > 1:  # peel a batch factor when the spatial grid is >= 2x2
        if n % 8 == 0:
            b = 2
            dy, dx = best_2d(n // 2)
            return b, dy, dx
    return 1, dy, dx


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Build a ('batch','dy','dx') mesh over the first n devices of the
    default platform (or of ``devices``). Raises ValueError when fewer
    devices are available than asked for: a mesh never moves to another
    platform behind the caller's back."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        platform = devices[0].platform if devices else "none"
        raise ValueError(
            f"make_mesh: {n_devices} devices requested but only "
            f"{len(devices)} available on platform {platform!r}"
        )
    b, dy, dx = factor3(n_devices)
    arr = np.array(devices[:n_devices]).reshape(b, dy, dx)
    return Mesh(arr, ("batch", "dy", "dx"))
