"""Edge-aware Laplacian weights (JAX).

Redesign of the reference's weight machinery
(src/GPUSolver.cu:136-224 loadIndexToWeight + :264-272 GPULoadWeights):

- The reference packs four LUT *indices* per pixel into an int2
  (left*1000+right, up*1000+down) and gathers exp(-beta*w) from a
  __constant__ LUT inside every sweep. The weights are loop-invariant across a level's sweeps, so we materialize four
  float32 weight planes (w_left, w_right, w_up, w_down) once per level —
  plus the reciprocal of their sum, hoisting the per-sweep division out of
  the hot loop entirely.
- The sentinel "no neighbor" index 256 -> LUT value 0 becomes a plain zero
  weight at the image border.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import DiffusionConfig


class EdgeWeights(NamedTuple):
    """Per-pixel neighbor weights and precomputed reciprocal row-sum."""

    wl: jnp.ndarray  # weight toward (y, x-1), 0 at x == 0
    wr: jnp.ndarray  # weight toward (y, x+1), 0 at x == W-1
    wu: jnp.ndarray  # weight toward (y-1, x), 0 at y == 0
    wd: jnp.ndarray  # weight toward (y+1, x), 0 at y == H-1
    inv_count: jnp.ndarray  # 1/(wl+wr+wu+wd), 0 where the sum vanishes


def _pad_edge_pairs(bh: jnp.ndarray, bv: jnp.ndarray, h: int, w: int) -> EdgeWeights:
    zc = jnp.zeros((h, 1), dtype=jnp.float32)
    zr = jnp.zeros((1, w), dtype=jnp.float32)
    wl = jnp.concatenate([zc, bh], axis=1)
    wr = jnp.concatenate([bh, zc], axis=1)
    wu = jnp.concatenate([zr, bv], axis=0)
    wd = jnp.concatenate([bv, zr], axis=0)
    count = wl + wr + wu + wd
    # A pixel is "isolated" (depth 0, src/GPUSolver.cu:103) when count == 0
    # or SUBNORMAL (< ~1.18e-38, all 4 neighbors at extreme contrast): the
    # reference GPU's flush-to-zero arithmetic lands such sums on its
    # count==0 branch, and flush-to-zero device code does the same — so the
    # cut must sit at the normal/subnormal boundary, not at reciprocal
    # overflow (~2.9e-39), or CPU (which keeps subnormals) and an FTZ
    # device would diverge in the band between. Every NORMAL sum takes the weighted-mean path with a
    # finite reciprocal (1/tiny ~ 8.5e37 < inf), exactly like the reference.
    tiny = jnp.float32(np.finfo(np.float32).tiny)
    inv_count = jnp.where(count >= tiny, jnp.float32(1.0) / count, jnp.float32(0.0))
    return EdgeWeights(wl, wr, wu, wd, inv_count)


def edge_weights(
    gray: jnp.ndarray,
    depth: jnp.ndarray | None,
    level: int,
    max_level: int,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> EdgeWeights:
    """Compute the 5-point stencil weights for one pyramid level.

    Reference rule (src/GPUSolver.cu:188-220):
    - coarsest level: w = exp(-beta * |gray(p)-gray(q)|)
    - finer levels:   w = exp(-beta * |gray(p)-gray(q)|) where the (uint8-
      truncated) upsampled depth differs by more than the threshold
      (4; forced 0 at level 0), else 1.0 — free diffusion where the coarse
      solution is already smooth.
    Weights are symmetric between neighbor pairs, so only one (H,W-1)
    horizontal and one (H-1,W) vertical plane is computed, then padded into
    the four directional planes.
    """
    h, w = gray.shape
    g = gray.astype(jnp.int32)
    beta = jnp.float32(cfg.beta)

    gsad_h = jnp.abs(g[:, 1:] - g[:, :-1]).astype(jnp.float32)
    gsad_v = jnp.abs(g[1:, :] - g[:-1, :]).astype(jnp.float32)
    # Flush SUBNORMAL weights (contrast > ~218 at beta=0.4) to zero
    # explicitly: CUDA's expf and XLA's vectorized exp flush them anyway
    # (FTZ), NumPy keeps them — pinning the boundary here makes oracle, CPU
    # and GPU agree bit-for-bit on which pixels take the isolated rule.
    tiny = jnp.float32(np.finfo(np.float32).tiny)
    base_h = jnp.exp(-beta * gsad_h)
    base_v = jnp.exp(-beta * gsad_v)
    base_h = jnp.where(base_h >= tiny, base_h, jnp.float32(0.0))
    base_v = jnp.where(base_v >= tiny, base_v, jnp.float32(0.0))

    if level == max_level:
        return _pad_edge_pairs(base_h, base_v, h, w)

    thr = 0 if level == 0 else cfg.depth_edge_threshold
    d8 = jnp.clip(depth, 0.0, 255.0).astype(jnp.uint8).astype(jnp.int32)
    dsad_h = jnp.abs(d8[:, 1:] - d8[:, :-1])
    dsad_v = jnp.abs(d8[1:, :] - d8[:-1, :])
    bh = jnp.where(dsad_h > thr, base_h, jnp.float32(1.0))
    bv = jnp.where(dsad_v > thr, base_v, jnp.float32(1.0))
    return _pad_edge_pairs(bh, bv, h, w)
