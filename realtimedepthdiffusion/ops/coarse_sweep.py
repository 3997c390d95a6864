"""Coarse-level Jacobi+Chebyshev sweeps in one GPU kernel (Pallas, Triton route).

Under XLA every sweep of a level is at least one kernel launch, and the
sweeps run strictly in sequence. On the coarse levels of the cascade
(67x120 at 1080p takes 1000 of the frame's 1937 sweeps) the launch, not the
data, is the cost. This kernel runs ALL of a level's sweeps in one launch:
one program (one CTA) per level, the loop inside the program, and a CTA-wide
barrier between sweeps.

Layout: the level is flattened with a row stride of ``s = w + 1``. Column 0
of every row is a zero, Dirichlet-pinned pixel that serves as the left
neighbour of the row's first pixel AND the right neighbour of the previous
row's last one; a zero row of ``s`` elements sits above and below. Real pixel
(y, x) lives at flat index ``s + y*s + x + 1``. A sweep updates the
power-of-two span ``[s, s + n)`` (``n = next_pow2(h*s)``, Triton's tensors are
powers of two), and reads its four neighbours as the same span shifted by
-1, +1, -s and +s, so no load needs a mask: every element past the real
pixels is a pinned zero with zero weights, exactly the reference's
index-256 "no neighbour" sentinel (src/GPUSolver.cu:222).

State: ``u`` and the Chebyshev history ``prev`` are carried in registers
across the sweep loop; the neighbour exchange goes through a two-slot
ping-pong buffer in device memory, which stays in the SM's L1. Sweep i reads
slot i%2 and writes slot 1-i%2, then a barrier makes the writes visible to
the whole CTA; a slot is only ever written after the barrier that ends the
sweep which read it, so one barrier per sweep suffices.

Arithmetic is the XLA solver's, term for term (core.solver
``solve_jacobi_chebyshev``): r = clip((wl*ul + wr*ur + wu*uu + wd*ud)*inv,
0, 255); u' = omega*(gamma*(r-u) + u - prev) + prev, pinned pixels kept.
Under the CPU interpreter the two agree bit for bit; on the card the
compilers may contract different multiply-adds.

Covers the fixed-count ``jacobi_chebyshev`` solver only; ``red_black``,
plain ``jacobi`` and the early-exit chunks stay on XLA (ops.dispatch).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import DiffusionConfig
from ..core.solver import chebyshev_omegas
from ..core.weights import EdgeWeights, edge_weights

# Hopper SM limits (NVIDIA H100 data sheet / Hopper tuning guide).
SM_REGISTER_BYTES = 65536 * 4   # 64K 32-bit registers
SM_SHARED_BYTES = 227 * 1024    # L1/shared memory one block may hold
# 32-bit values per element that stay live across the sweep loop: u, prev,
# the four weight views (wl, wr, wu, wd), inv and the pinned mask.
LIVE_PLANES = 8
MAX_WARPS = 32                  # 1024 threads, the CTA limit
ELEMS_PER_THREAD = 8


def layout(h: int, w: int):
    """(row stride s, updated span n, buffer length) of an h x w level."""
    s = w + 1
    n = pl.next_power_of_2(h * s)
    return s, n, n + 2 * s


def fits(h: int, w: int) -> bool:
    """Whether an h x w level goes to the kernel: its loop-carried planes
    must fit one SM's on-chip storage, the register file plus what L1 can
    hold of the spill (Triton spills registers to local memory, which stays
    in L1 while it fits). 1080p: only the 67x120 level (n = 8192) fits."""
    _, n, _ = layout(h, w)
    return n * LIVE_PLANES * 4 <= SM_REGISTER_BYTES + SM_SHARED_BYTES


def num_warps(h: int, w: int) -> int:
    """Warps for the level's CTA: ELEMS_PER_THREAD elements per thread per
    plane, between 4 warps and the 1024-thread limit."""
    _, n, _ = layout(h, w)
    return max(4, min(MAX_WARPS, n // (32 * ELEMS_PER_THREAD)))


def _kernel(om_ref, m_ref, bh_ref, bv_ref, inv_ref, u_in_ref, u_ref, *,
            iters, s, n, gamma, barrier):
    del u_in_ref  # aliased to u_ref: slot 0 seeded, slot 1 its copy
    c = pl.ds(s, n)
    pinned = m_ref[c] != 0
    wl = bh_ref[pl.ds(s - 1, n)]
    wr = bh_ref[c]
    wu = bv_ref[pl.ds(0, n)]
    wd = bv_ref[c]
    inv = inv_ref[c]
    u0 = u_ref[0, c]

    def sweep(i, carry):
        u, prev = carry
        src = lax.rem(i, 2)
        ul = u_ref[src, pl.ds(s - 1, n)]
        ur = u_ref[src, pl.ds(s + 1, n)]
        uu = u_ref[src, pl.ds(0, n)]
        ud = u_ref[src, pl.ds(2 * s, n)]
        r = jnp.clip((wl * ul + wr * ur + wu * uu + wd * ud) * inv, 0.0, 255.0)
        omega = om_ref[i]
        new = jnp.where(pinned, u, omega * (gamma * (r - u) + u - prev) + prev)
        u_ref[1 - src, c] = new
        if barrier:  # the interpreter runs one program in order: no barrier
            plgpu.debug_barrier()
        return new, u

    u, _ = lax.fori_loop(0, iters, sweep, (u0, jnp.zeros_like(u0)))
    u_ref[0, c] = u


def pack(plane: jnp.ndarray, fill=0) -> jnp.ndarray:
    """(h, w) plane -> the kernel's flat padded layout (module docstring)."""
    h, w = plane.shape
    s, n, length = layout(h, w)
    rows = jnp.pad(plane, ((0, 0), (1, 0)), constant_values=fill).reshape(-1)
    return jnp.pad(rows, (s, length - s - h * s), constant_values=fill)


def unpack(flat: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    s = w + 1
    return flat[s : s + h * s].reshape(h, s)[:, 1:]


def sweeps(depth: jnp.ndarray, mask: jnp.ndarray, wts: EdgeWeights,
           iters: int, cfg: DiffusionConfig = DiffusionConfig(),
           interpret: bool = False) -> jnp.ndarray:
    """``iters`` fixed-count Jacobi+Chebyshev sweeps of one level, all in one
    kernel launch; same contract as core.solver.solve_jacobi_chebyshev with
    early exit off."""
    u = depth.astype(jnp.float32)
    if iters <= 0:
        return u
    h, w = u.shape
    s, n, length = layout(h, w)
    up = pack(u)
    kernel = functools.partial(
        _kernel, iters=iters, s=s, n=n,
        gamma=float(cfg.chebyshev_gamma), barrier=not interpret,
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((2, length), jnp.float32),
        input_output_aliases={5: 0},
        interpret=interpret,
        backend=None if interpret else "triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps(h, w), num_stages=1
        ),
        name="coarse_sweeps",
    )(
        jnp.asarray(chebyshev_omegas(iters, cfg)),
        pack(mask.astype(jnp.int32), fill=1),
        pack(wts.wr),
        pack(wts.wd),
        pack(wts.inv_count),
        jnp.stack([up, up]),
    )
    return unpack(out[0], h, w)


def solve_level(depth, mask, gray, level, max_level, iters,
                cfg: DiffusionConfig = DiffusionConfig(), interpret=False):
    """Weights + kernel sweeps for one pyramid level (core.solver.solve_level
    twin for the fixed-count jacobi_chebyshev solver)."""
    wts = edge_weights(gray, depth, level, max_level, cfg)
    return sweeps(depth, mask, wts, iters, cfg, interpret)
