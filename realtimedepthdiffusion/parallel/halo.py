"""k-wide halo exchange over a 2-D spatial mesh (shard_map + ppermute).

The multi-device analog of the reference's 16x16 shared-memory tiles with
1-px halo (src/GPUSolver.cu:239-245): each device owns a spatial block of
the image and exchanges a k-row/column halo with its mesh neighbors
(ppermute; NCCL on GPUs). Exchanging a k-wide halo every k sweeps
(iteration blocking) amortizes the exchange latency — k local sweeps shrink the halo's validity by one per sweep,
leaving the interior exact (corners are never read by a 5-point stencil
within k sweeps, so diagonal neighbors are not exchanged; same argument as
the CUDA tile corners, SURVEY.md §5 race notes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _perm(n: int, up: bool):
    """Shift permutation along an axis of size n (no wraparound: boundary
    blocks receive zeros, which is correct because true image-boundary
    weights are zero)."""
    if up:
        return [(i, i - 1) for i in range(1, n)]
    return [(i, i + 1) for i in range(n - 1)]


def extend_with_halo(x: jnp.ndarray, k: int, axis_y: str = "dy", axis_x: str = "dx") -> jnp.ndarray:
    """Inside shard_map: return the local block extended by a k-wide halo of
    neighbor data on all four sides. The two-stage exchange (rows first, then
    columns of the row-extended block) also carries true diagonal-neighbor
    data into the corners — more than a 5-point stencil strictly needs within
    k sweeps, but exact. Must be called inside shard_map over
    (axis_y, axis_x). The spatial block is the LAST two axes; leading axes
    (e.g. a local batch) ride along — one exchange serves the whole local
    batch."""
    ny = lax.axis_size(axis_y)
    nx = lax.axis_size(axis_x)

    # My top halo is the up-neighbor's bottom k rows: data flows i-1 -> i,
    # i.e. perm pairs (i, i+1) with every source sending its bottom rows.
    top_halo = lax.ppermute(x[..., -k:, :], axis_y, _perm(ny, up=False))
    # My bottom halo is the down-neighbor's top k rows: flows i+1 -> i.
    bot_halo = lax.ppermute(x[..., :k, :], axis_y, _perm(ny, up=True))
    xv = jnp.concatenate([top_halo, x, bot_halo], axis=-2)  # (..., h+2k, w)

    left_halo = lax.ppermute(xv[..., :, -k:], axis_x, _perm(nx, up=False))
    right_halo = lax.ppermute(xv[..., :, :k], axis_x, _perm(nx, up=True))
    return jnp.concatenate([left_halo, xv, right_halo], axis=-1)  # (..., h+2k, w+2k)


def crop_halo(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Drop the k-wide halo ring (last two axes)."""
    return x[..., k:-k, k:-k]
