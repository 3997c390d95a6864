"""Pure-NumPy reference backend ("fake backend" per SURVEY.md §4).

This module is the semantic ground truth for the whole framework: every JAX /
Pallas implementation is unit-tested against these functions. It re-derives —
it does not translate — the behavior of the CUDA reference
(/root/reference/src/GPUSolver.cu, GPUImageProcessing.cu, GPUDepthEffect.cu)
in float32 NumPy, with three documented, intentional deviations:

1. ``sum / count`` is computed as ``sum * (1 / count)`` (precomputed
   reciprocal) so that the XLA solver and the GPU kernel, which hoist the
   reciprocal out of the hot sweep loop, match the oracle to the last ulp. The difference from a
   true division is <=1 ulp per sweep and vanishes under the diffusion's
   contraction.
2. Depth values are clipped to [0, 255] before the uint8 truncation used by
   the level-dependent edge rule (the reference's raw C cast of a possibly
   out-of-range float to ``unsigned char`` is undefined behavior —
   src/GPUSolver.cu:168/199 reading unclamped Chebyshev output).
3. SUBNORMAL weight sums (count < ~1.18e-38 — all four neighbors at extreme
   contrast) take the "isolated pixel -> 0" rule instead of dividing: the
   reference GPU's flush-to-zero arithmetic lands exactly these sums on its
   count==0 branch (src/GPUSolver.cu:103), and flush-to-zero device code
   does the same, so cutting at the normal/subnormal boundary keeps the
   CPU oracle and the device product bit-consistent. Every NORMAL sum takes the weighted-mean
   path with a finite reciprocal, exactly like the reference.

Everything here is single-threaded NumPy and runs with no JAX at all.
"""

from __future__ import annotations

import numpy as np

from ..config import DiffusionConfig

F32 = np.float32

# ---------------------------------------------------------------------------
# Color (OpenCV-compatible fixed-point gray conversion)
# ---------------------------------------------------------------------------


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """RGB (H,W,3) uint8 -> gray uint8 with OpenCV's fixed-point weights.

    Matches cv::cvtColor(BGR2GRAY) (src/main.cpp:111,138) bit-for-bit:
    (R*9798 + G*19235 + B*3735 + 16384) >> 15.
    """
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


# ---------------------------------------------------------------------------
# Pyramids — single floor-size convention (fixes reference quirk #7)
# ---------------------------------------------------------------------------

_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float64) / 16.0
_PYR_KI = np.array([1, 4, 6, 4, 1], dtype=np.int64)


def _reflect101_pad2(a: np.ndarray) -> np.ndarray:
    """Pad 2 on each edge of the leading two axes with reflect-101."""
    pad = [(2, 2), (2, 2)] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, mode="reflect")


def _pyr_down_gray_to(gray: np.ndarray, oh: int, ow: int) -> np.ndarray:
    h, w = gray.shape
    p = _reflect101_pad2(gray).astype(np.int64)
    # Horizontal pass at even output columns (slice ends clamp, so the ceil
    # size on an odd axis still yields exactly ow samples).
    acc = np.zeros((h + 4, ow), dtype=np.int64)
    for t in range(5):
        acc += _PYR_KI[t] * p[:, t : t + 2 * ow : 2]
    # Vertical pass at even output rows.
    out = np.zeros((oh, ow), dtype=np.int64)
    for t in range(5):
        out += _PYR_KI[t] * acc[t : t + 2 * oh : 2, :]
    return ((out + 128) >> 8).astype(np.uint8)


def pyr_down_gray(gray: np.ndarray) -> np.ndarray:
    """Gaussian 5-tap pyrDown for uint8, output size (H//2, W//2).

    Same filter and fixed-point rounding as OpenCV's 8U pyrDown
    (kernel outer([1,4,6,4,1]), sum 256, round-half-up), BORDER_REFLECT_101,
    sampled at even coordinates — with *floor* output size.
    """
    h, w = gray.shape
    return _pyr_down_gray_to(gray, h // 2, w // 2)


def pyr_down_gray_ceil(gray: np.ndarray) -> np.ndarray:
    """cv::pyrDown's native ceil output size — bit-exact with cv2.pyrDown
    (tests/test_faithful.py). Feeds the reference-faithful gray chain."""
    h, w = gray.shape
    return _pyr_down_gray_to(gray, (h + 1) // 2, (w + 1) // 2)


def pyr_up(src: np.ndarray, out_shape: tuple) -> np.ndarray:
    """Gaussian pyrUp for float32 to an explicit target size.

    Zero-insertion upsampling followed by the 5-tap kernel scaled x2 per axis
    (cv::pyrUp semantics, src/main.cpp:273/277), reflect-101 borders, floor
    convention: target may be 2h or 2h+1 per axis.

    Border semantics match cv::pyrUp (verified against cv2 directly in
    tests/test_faithful.py): reflect-101 applied to the *zero-inserted*
    grid, and the odd-size extension is AXIS-ASYMMETRIC the way OpenCV's
    horizontal-then-vertical implementation makes it — an odd-height target
    copies the previous even output row (out[2h] = out[2h-2]) while an
    odd-width target takes the last *source* column at full kernel weight
    (out[:, 2w] = 8*src[:, w-1]/8, i.e. the vertically-filtered last
    column).
    """
    oh, ow = out_shape

    def axis_up(a: np.ndarray, n_out: int, odd_copy_out: bool) -> np.ndarray:
        h = a.shape[0]
        z = np.zeros((2 * h,) + a.shape[1:], dtype=F32)
        z[0::2] = a
        zp = np.pad(z, [(2, 2)] + [(0, 0)] * (a.ndim - 1), mode="reflect")
        out = (
            zp[0 : 2 * h]
            + F32(4.0) * zp[1 : 2 * h + 1]
            + F32(6.0) * zp[2 : 2 * h + 2]
            + F32(4.0) * zp[3 : 2 * h + 3]
            + zp[4 : 2 * h + 4]
        ) * F32(0.125)
        if n_out == 2 * h + 1:
            extra = out[2 * h - 2 : 2 * h - 1] if odd_copy_out else a[h - 1 : h]
            out = np.concatenate([out, extra.astype(F32)], axis=0)
        return out[:n_out]

    t = axis_up(src.astype(F32), oh, odd_copy_out=True)
    t = np.moveaxis(axis_up(np.moveaxis(t, 1, 0), ow, odd_copy_out=False), 0, 1)
    return t.astype(F32)


# ---------------------------------------------------------------------------
# Annotation ops (GPUImageProcessing.cu semantics)
# ---------------------------------------------------------------------------


def annotation_pyr_down(mask: np.ndarray, value: np.ndarray, out_shape: tuple):
    """Downsample a scribble annotation one level (pyrDown kernel,
    src/GPUImageProcessing.cu:23-49).

    Coarse pixel (y,x) scans the fine 2x2 window {2y-1,2y}x{2x-1,2x} in
    row-major order; if any fine pixel is masked, the coarse pixel is masked
    and takes the *last* masked fine value in scan order (last writer wins:
    (2y,2x) has highest priority, then (2y,2x-1), (2y-1,2x), (2y-1,2x-1)).
    """
    oh, ow = out_shape
    h, w = mask.shape
    out_mask = np.zeros((oh, ow), dtype=bool)
    out_val = np.zeros((oh, ow), dtype=np.uint8)
    ys = np.arange(oh)
    xs = np.arange(ow)
    # Scan order: (2y-1,2x-1), (2y-1,2x), (2y,2x-1), (2y,2x) — later wins.
    for dy in (-1, 0):
        for dx in (-1, 0):
            py = 2 * ys + dy
            px = 2 * xs + dx
            yv = (py >= 0) & (py < h)
            xv = (px >= 0) & (px < w)
            pyc = np.clip(py, 0, h - 1)
            pxc = np.clip(px, 0, w - 1)
            m = mask[np.ix_(pyc, pxc)] & yv[:, None] & xv[None, :]
            v = value[np.ix_(pyc, pxc)]
            out_val = np.where(m, v, out_val)
            out_mask |= m
    return out_mask, out_val


def seed_depth(depth: np.ndarray, mask: np.ndarray, value: np.ndarray) -> np.ndarray:
    """Dirichlet seeding (convert kernel, src/GPUImageProcessing.cu:8-21):
    where masked, depth := scribble value; elsewhere unchanged."""
    return np.where(mask, value.astype(F32), depth.astype(F32))


def paint(mask: np.ndarray, value: np.ndarray, x: int, y: int, color: int, radius: int):
    """Square-brush paint (paintImage kernel, src/GPUImageProcessing.cu:51-70).

    Paints pixels with |px - x| <= radius/2 and |py - y| <= radius/2
    (integer-truncated half-width; the brush is a square, and a negative
    radius paints nothing beyond the center column/row exactly like the
    reference's unclamped int math would for radius >= 0; we clamp radius at
    0 — SURVEY.md quirk #6).
    """
    h, w = mask.shape
    half = max(radius, 0) // 2
    y0, y1 = max(y - half, 0), min(y + half, h - 1)
    x0, x1 = max(x - half, 0), min(x + half, w - 1)
    mask = mask.copy()
    value = value.copy()
    if y0 <= y1 and x0 <= x1:
        mask[y0 : y1 + 1, x0 : x1 + 1] = True
        value[y0 : y1 + 1, x0 : x1 + 1] = np.uint8(color)
    return mask, value


# ---------------------------------------------------------------------------
# Edge weights (GPULoadWeights + loadIndexToWeight semantics)
# ---------------------------------------------------------------------------


def edge_weights(
    gray: np.ndarray,
    depth: np.ndarray | None,
    level: int,
    max_level: int,
    cfg: DiffusionConfig = DiffusionConfig(),
):
    """Per-pixel neighbor weights (w_left, w_right, w_up, w_down), float32.

    Reference semantics (src/GPUSolver.cu:136-224 + :264-272):
    - base weight  w = exp(-beta * |gray(p) - gray(q)|)   (the LUT values)
    - coarsest level (level == max_level): always the base weight
    - finer levels: if |u8(depth(p)) - u8(depth(q))| > threshold use the base
      weight, else 1.0 (free diffusion where upsampled depth is smooth);
      threshold = cfg.depth_edge_threshold, forced to 0 at level 0
    - out-of-image neighbor: weight 0 (the reference's sentinel index 256
      mapping to LUT entry 0.0)
    """
    g = gray.astype(np.int32)
    beta = F32(cfg.beta)

    def base_w(sad):
        w = np.exp((-beta) * sad.astype(F32)).astype(F32)
        # Flush subnormal weights to zero like CUDA's expf / XLA's exp (FTZ);
        # NumPy alone keeps them. Pins the isolated-pixel boundary at
        # contrast ~218 (beta=0.4) identically across oracle, CPU and GPU.
        return np.where(w >= np.finfo(np.float32).tiny, w, F32(0.0)).astype(F32)

    h, w = gray.shape
    wl = np.zeros((h, w), dtype=F32)
    wr = np.zeros((h, w), dtype=F32)
    wu = np.zeros((h, w), dtype=F32)
    wd = np.zeros((h, w), dtype=F32)

    gsad_h = np.abs(g[:, 1:] - g[:, :-1])  # (h, w-1): between x-1 and x
    gsad_v = np.abs(g[1:, :] - g[:-1, :])  # (h-1, w)

    if level == max_level:
        wl[:, 1:] = base_w(gsad_h)
        wr[:, :-1] = base_w(gsad_h)
        wu[1:, :] = base_w(gsad_v)
        wd[:-1, :] = base_w(gsad_v)
    else:
        thr = 0 if level == 0 else cfg.depth_edge_threshold
        d8 = np.clip(depth, 0.0, 255.0).astype(np.uint8).astype(np.int32)
        dsad_h = np.abs(d8[:, 1:] - d8[:, :-1])
        dsad_v = np.abs(d8[1:, :] - d8[:-1, :])
        bh = np.where(dsad_h > thr, base_w(gsad_h), F32(1.0))
        bv = np.where(dsad_v > thr, base_w(gsad_v), F32(1.0))
        wl[:, 1:] = bh
        wr[:, :-1] = bh
        wu[1:, :] = bv
        wd[:-1, :] = bv
    return wl, wr, wu, wd


# ---------------------------------------------------------------------------
# Chebyshev schedule (src/GPUSolver.cu:282-299)
# ---------------------------------------------------------------------------


def chebyshev_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """The per-iteration omega sequence, reproducing the reference's mixed
    float/double arithmetic: omega is stored in float32 but each update is
    evaluated in float64 (C literals 2.0/4.0 promote)."""
    s = cfg.chebyshev_s
    # `rho * rho * omega` is a float32 chain in C (left-assoc float ops);
    # only the subtraction against the 2.0/4.0 double literals promotes.
    rho2 = F32(cfg.chebyshev_rho) * F32(cfg.chebyshev_rho)
    out = np.empty(iters, dtype=F32)
    omega = F32(0.0)
    for i in range(iters):
        if i < s:
            omega = F32(1.0)
        elif i == s:
            omega = F32(2.0 / (2.0 - np.float64(rho2)))
        else:
            omega = F32(4.0 / (4.0 - np.float64(rho2 * omega)))
        out[i] = omega
    return out


def rb_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Cyclic-Chebyshev (Golub-Varga) SOR omegas for the red-black
    half-sweeps — the independent twin of core.solver.rb_omegas (same
    recurrence, re-derived here so the oracle shares no code with the
    implementation under test). (iters, 2) float32; all-ones when
    cfg.rb_chebyshev is off."""
    n = max(iters, 1)
    out = np.ones((n, 2), dtype=F32)
    if cfg.rb_chebyshev:
        rho2 = float(F32(cfg.rb_rho)) ** 2
        s = cfg.chebyshev_s
        omega = 1.0
        for half in range(2 * n):
            if half < s:
                omega = 1.0
            elif half == s:
                omega = 1.0 / (1.0 - rho2 / 2.0)
            else:
                omega = 1.0 / (1.0 - rho2 * omega / 4.0)
            out[half // 2, half % 2] = F32(omega)
    return out[:iters]


# ---------------------------------------------------------------------------
# The solver (matrixFreeSolver / solveDiffusion semantics)
# ---------------------------------------------------------------------------


def _inv_count(count: np.ndarray) -> np.ndarray:
    """Reciprocal weight sum; 0 where count is zero or SUBNORMAL — the
    reference's "isolated pixel" branch (src/GPUSolver.cu:103), which its
    GPU's flush-to-zero arithmetic reaches for any subnormal sum. Cutting at
    the normal/subnormal boundary keeps CPU (NumPy, keeps subnormals) and
    flush-to-zero devices on identical semantics. See deviation #3 in the
    module doc."""
    count = count.astype(F32)
    with np.errstate(divide="ignore"):
        inv = F32(1.0) / count
    return np.where(count >= np.finfo(np.float32).tiny, inv, F32(0.0)).astype(F32)


def jacobi_sweep(u, wl, wr, wu, wd, inv_count):
    """One weighted 5-point Jacobi relaxation (solveDiffusion,
    src/GPUSolver.cu:73-106): u'(p) = clip(sum_i w_i u(q_i) * inv_count, 0, 255),
    0 where all weights vanish (inv_count == 0)."""
    u = u.astype(F32)
    s = np.zeros_like(u)
    s[:, 1:] += wl[:, 1:] * u[:, :-1]
    s[:, :-1] += wr[:, :-1] * u[:, 1:]
    s[1:, :] += wu[1:, :] * u[:-1, :]
    s[:-1, :] += wd[:-1, :] * u[1:, :]
    return np.clip(s * inv_count, F32(0.0), F32(255.0)).astype(F32)


def solve_level(
    depth: np.ndarray,
    mask: np.ndarray,
    gray: np.ndarray,
    level: int,
    max_level: int,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> np.ndarray:
    """Fixed-iteration Jacobi + Chebyshev solve at one pyramid level
    (GPUMatrixFreeSolver, src/GPUSolver.cu:274-316).

    ``depth`` must already be seeded (mask pixels hold their Dirichlet
    values). Scribbled pixels are never updated (the kernel's early return at
    src/GPUSolver.cu:248); the Chebyshev history starts at zero
    (src/GPUSolver.cu:290). The extrapolated update is *not* clamped — only
    the inner Jacobi average is (src/GPUSolver.cu:104 vs :259).
    """
    wl, wr, wu, wd = edge_weights(gray, depth, level, max_level, cfg)
    inv_count = _inv_count(wl + wr + wu + wd)
    gamma = F32(cfg.chebyshev_gamma)
    omegas = chebyshev_omegas(iters, cfg)

    u = depth.astype(F32).copy()
    prev = np.zeros_like(u)
    for i in range(iters):
        omega = omegas[i]
        result = jacobi_sweep(u, wl, wr, wu, wd, inv_count)
        out = omega * (gamma * (result - u) + u - prev) + prev
        new_u = np.where(mask, u, out).astype(F32)
        prev = u
        u = new_u
    return u


def solve_level_red_black(
    depth, mask, gray, level, max_level, iters,
    cfg: DiffusionConfig = DiffusionConfig(),
    tolerance: float | None = None,
):
    """Red-black Gauss-Seidel variant (BASELINE.json config #2) with optional
    residual early exit and the cyclic-Chebyshev SOR half-sweep omegas
    (core.solver.rb_omegas; plain Gauss-Seidel when cfg.rb_chebyshev is
    off). Not part of the reference (which ignores its tolerance parameter,
    src/main.cpp:264); defined here as the oracle for the framework's
    extended solver. PROJECTED SOR: the extrapolation
    clip(u + omega*(avg - u), 0, 255) keeps the iterate in range and
    reduces exactly to plain Gauss-Seidel at omega == 1."""
    wl, wr, wu, wd = edge_weights(gray, depth, level, max_level, cfg)
    inv_count = _inv_count(wl + wr + wu + wd)
    h, w = depth.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    red = ((yy + xx) % 2) == 0
    om = rb_omegas(max(iters, 1), cfg)

    u = depth.astype(F32).copy()
    check_every = max(int(cfg.residual_check_every), 1)
    for i in range(iters):
        for color, omega in ((red, om[i, 0]), (~red, om[i, 1])):
            upd = jacobi_sweep(u, wl, wr, wu, wd, inv_count)
            u = np.where(
                color & ~mask,
                np.clip(u + omega * (upd - u), F32(0.0), F32(255.0)),
                u,
            )
        # Residual checked on the same cadence as core.solver.solve_red_black
        # (every cfg.residual_check_every iterations), so both early-exit
        # implementations stop at the same iterate.
        if tolerance is not None and (i + 1) % check_every == 0:
            r = jacobi_sweep(u, wl, wr, wu, wd, inv_count)
            d = np.where(mask, F32(0.0), r - u)
            if cfg.residual_metric == "max":
                res = np.max(np.abs(d))
            else:  # "rms" — core.solver.residual_rms semantics
                cnt = max(float(np.sum(~mask)), 1.0)
                res = np.sqrt(float(np.sum(d * d)) / cnt)
            if res < tolerance * F32(255.0):
                break
    return u


# ---------------------------------------------------------------------------
# Coarse-to-fine driver (src/main.cpp:232-295)
# ---------------------------------------------------------------------------


def solve_pyramid(
    gray0: np.ndarray,
    mask0: np.ndarray,
    value0: np.ndarray,
    depth_state: list | None = None,
    cfg: DiffusionConfig = DiffusionConfig(),
):
    """Full cascadic multigrid solve. Returns (depth0_f32, new_depth_state).

    Mirrors the reference solve pass: downsample gray + annotation pyramids,
    seed the coarsest depth, then for each level coarse->fine: solve with
    iters = max_iterations / 2^((L-1)-level), pyrUp into the next level and
    re-seed the scribbles. ``depth_state`` carries the per-level depth maps
    between calls (the reference's persistent deviceDepthImage pyramid,
    src/main.cpp:135-136, which warm-starts subsequent solves).
    """
    h, w = gray0.shape
    levels = cfg.num_levels(h, w)
    sizes = [cfg.level_size(h, w, l) for l in range(levels)]

    grays = [gray0]
    masks = [mask0]
    values = [value0]
    gray_full = gray0  # ceil chain for gray_pyramid="opencv" (see multigrid)
    for l in range(1, levels):
        if cfg.gray_pyramid == "opencv":
            gray_full = pyr_down_gray_ceil(gray_full)
            grays.append(gray_full[: sizes[l][0], : sizes[l][1]])
        else:
            grays.append(pyr_down_gray(grays[-1])[: sizes[l][0], : sizes[l][1]])
        m, v = annotation_pyr_down(masks[-1], values[-1], sizes[l])
        masks.append(m)
        values.append(v)

    if depth_state is None:
        depth_state = [np.full(s, cfg.depth_init, dtype=F32) for s in sizes]
    depth_state = [d.copy() for d in depth_state]

    L = levels - 1
    depth_state[L] = seed_depth(depth_state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        depth_state[level] = solve_level(
            depth_state[level], masks[level], grays[level], level, L, iters, cfg
        )
        if level > 0:
            up = pyr_up(depth_state[level], sizes[level - 1])
            depth_state[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
    return depth_state[0], depth_state


# ---------------------------------------------------------------------------
# Effects (GPUDepthEffect.cu semantics)
# ---------------------------------------------------------------------------


def desaturation(rgb: np.ndarray, gray: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """f = depth/255; out = f*gray + (1-f)*color, truncated to uint8
    (simulateDesaturation, src/GPUDepthEffect.cu:8-27). Output clipped to
    [0,255] before the cast (documented deviation: the reference's raw cast
    is UB for out-of-range depth)."""
    f = (depth.astype(F32) / F32(255.0))[..., None]
    out = f * gray.astype(F32)[..., None] + (F32(1.0) - f) * rgb.astype(F32)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def haze(rgb: np.ndarray, depth: np.ndarray, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """t = exp(-haze_beta*depth/255); out = t*color + (1-t)*airlight
    (simulateHaze, src/GPUDepthEffect.cu:74-93)."""
    t = np.exp(-F32(cfg.haze_beta) * depth.astype(F32) / F32(255.0))[..., None]
    out = t * rgb.astype(F32) + (F32(1.0) - t) * F32(cfg.haze_airlight)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def defocus_naive(rgb: np.ndarray, depth: np.ndarray, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Depth-proportional box blur, naive O(k^2) gather — the literal oracle
    for simulateDefocus (src/GPUDepthEffect.cu:29-72). Window half-width is
    int(kernel * depth/255) / 2 with C truncation; empty window passes the
    source pixel through."""
    h, w = depth.shape
    k = cfg.defocus_kernel_size(h, w)
    out = np.empty_like(rgb)
    rgbf = rgb.astype(F32)
    for y in range(h):
        for x in range(w):
            ka = int(F32(k) * max(F32(depth[y, x]), F32(0.0)) / F32(255.0))
            half = ka // 2
            y0, y1 = max(y - half, 0), min(y + half - 1, h - 1)
            x0, x1 = max(x - half, 0), min(x + half - 1, w - 1)
            if half == 0 or y0 > y1 or x0 > x1:
                out[y, x] = rgb[y, x]
            else:
                win = rgbf[y0 : y1 + 1, x0 : x1 + 1]
                cnt = F32(win.shape[0] * win.shape[1])
                out[y, x] = (win.sum(axis=(0, 1), dtype=F32) / cnt).astype(np.uint8)
    return out


def defocus(rgb: np.ndarray, depth: np.ndarray, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Summed-area-table defocus: exact integer box sums (int64 SAT), O(1)
    per pixel — the formulation core.effects.defocus implements. Matches
    ``defocus_naive`` up to f32 division rounding (<=1 uint8 step)."""
    h, w = depth.shape
    k = cfg.defocus_kernel_size(h, w)
    ka = (F32(k) * np.maximum(depth.astype(F32), F32(0.0)) / F32(255.0)).astype(np.int32)
    half = ka // 2
    sat = np.zeros((h + 1, w + 1, 3), dtype=np.int64)
    np.cumsum(np.cumsum(rgb.astype(np.int64), axis=0), axis=1, out=sat[1:, 1:])
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    y0 = np.maximum(yy - half, 0)
    y1 = np.minimum(yy + half - 1, h - 1)
    x0 = np.maximum(xx - half, 0)
    x1 = np.minimum(xx + half - 1, w - 1)
    cnt = ((y1 - y0 + 1) * (x1 - x0 + 1)).astype(np.int64)
    box = (
        sat[y1 + 1, x1 + 1] - sat[y0, x1 + 1] - sat[y1 + 1, x0] + sat[y0, x0]
    )
    empty = (half == 0) | (y0 > y1) | (x0 > x1)
    mean = (box.astype(F32) / np.maximum(cnt, 1).astype(F32)[..., None]).astype(np.uint8)
    return np.where(empty[..., None], rgb, mean)
