"""Quality ledger for the localized incremental re-solve (live painting).

Round-3 verdict weakness #4: the windowed live path (core/incremental.py)
was gated by exactly two RMSE asserts; the feature backing BASELINE config
#5 deserves a measured 12-pair table. This tool applies a scripted
3-stroke editing sequence to every dataset pair and, after each stroke,
compares the incremental trajectory (state carried through *incremental*
solves — accumulated drift, the honest live scenario) against the ground
truth trajectory (state carried through *full warm* re-solves of the same
edits), for ``incremental_global_smooth`` in {0, 2, 4}:

  - rmse:  normalized RMSE over the depth map (/255)
  - max:   normalized max abs error
  - seam:  normalized RMSE over a 4-px band straddling the incremental
           window's border at level 0 (where a purely local solve would
           leave a visible line)

Strokes (deterministic per pair):
  1. extend  — grow an existing scribble by a 20x20 block (same depth)
  2. island  — new scribble in the most annotation-distant region, depth 64
  3. flip    — repaint the extension at the opposite depth (255 - v)
  4. twin    — TWO simultaneous distant strokes in one frame, solved as two
     sequential windowed re-solves through the same compiled program (the
     session's multi-rect path, round-5) vs ONE full warm re-solve

Output: a markdown table (per-pair and summary rows) for PERF.md/PARITY.md.

    JAX_PLATFORMS=cpu \
        python tools/incremental_report.py [--pairs Dog,Flower] [--gs 0,2,4]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATASET = "/root/reference/dataset"


def _farthest_from_mask(mask: np.ndarray, step: int = 16):
    """Grid point maximizing L2 distance to the annotated set (subsampled —
    exact enough to script an 'island' stroke, no scipy dependency)."""
    ys, xs = np.nonzero(mask[::step, ::step])
    py, px = ys * step, xs * step
    h, w = mask.shape
    gy, gx = np.mgrid[step : h - step : step, step : w - step : step]
    d2 = np.full(gy.shape, np.inf)
    for y, x in zip(py, px):
        d2 = np.minimum(d2, (gy - y) ** 2.0 + (gx - x) ** 2.0)
    i = int(np.argmax(d2))
    return int(gy.flat[i]), int(gx.flat[i])


def scripted_strokes(mask: np.ndarray, value: np.ndarray):
    """Three deterministic (my, mx, val, center) edits for a pair."""
    ys, xs = np.nonzero(mask)
    cy, cx = int(ys[len(ys) // 2]), int(xs[len(xs) // 2])
    v = int(value[cy, cx])
    h, w = mask.shape
    ey = min(cy + 25, h - 11)
    ex = min(cx + 25, w - 11)
    iy, ix = _farthest_from_mask(mask)
    return [
        ("extend", ey, ex, v),
        ("island", iy, ix, 64),
        ("flip", ey, ex, 255 - v),
    ]


def _seam_band(h, w, cy, cx, win):
    """Bool map of the 4-px band straddling the level-0 window border,
    replicating dynamic_slice's start clamping."""
    oy = min(max(cy - win // 2, 0), max(h - win, 0))
    ox = min(max(cx - win // 2, 0), max(w - win, 0))
    band = np.zeros((h, w), bool)
    for e in (oy, oy + win - 1):
        band[max(e - 2, 0) : e + 2, max(ox - 2, 0) : ox + win + 2] = True
    for e in (ox, ox + win - 1):
        band[max(oy - 2, 0) : oy + win + 2, max(e - 2, 0) : e + 2] = True
    return band


def run_pair(rgb, mask0, value0, gs_values, cfg_kw):
    import jax.numpy as jnp

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.pipeline import DepthPipeline

    h, w = rgb.shape[:2]
    rows = []
    for gs in gs_values:
        cfg = DiffusionConfig(
            incremental_iterations=120, incremental_global_smooth=gs, **cfg_kw
        )
        pipe = DepthPipeline(h, w, cfg)
        _, gp = pipe.prepare_image(rgb)
        m = jnp.asarray(mask0)
        v = jnp.asarray(value0)
        _, st0 = pipe.solve(gp, m, v, pipe.initial_state())
        st_inc = tuple(jnp.array(s) for s in st0)  # incremental trajectory
        st_full = tuple(jnp.array(s) for s in st0)  # ground-truth trajectory
        mask, value = mask0.copy(), value0.copy()
        strokes = scripted_strokes(mask0, value0)
        for stroke, sy, sx, val in strokes:
            mask[sy - 10 : sy + 10, sx - 10 : sx + 10] = True
            value[sy - 10 : sy + 10, sx - 10 : sx + 10] = val
            m, v = jnp.asarray(mask), jnp.asarray(value)
            center = jnp.asarray([sy, sx], jnp.int32)
            d_inc, st_inc = pipe.solve_incremental(gp, m, v, st_inc, center)
            d_full, st_full = pipe.solve(gp, m, v, st_full)
            err = (np.asarray(d_inc) - np.asarray(d_full)) / 255.0
            band = _seam_band(h, w, sy, sx, cfg.incremental_window)
            rows.append(
                dict(
                    gs=gs,
                    stroke=stroke,
                    rmse=float(np.sqrt(np.mean(err**2))),
                    maxerr=float(np.abs(err).max()),
                    seam=float(np.sqrt(np.mean(err[band] ** 2))),
                )
            )
        # Twin: two distant strokes LANDING TOGETHER, incremental path =
        # sequential windowed solves (session multi-rect); full path = one
        # warm re-solve seeing both. Both trajectories start from the same
        # post-flip GROUND-TRUTH state so the row isolates the multi-rect
        # path's own error (strokes 1-3 already measure accumulated drift).
        # Sites: offset from the extend site and the island site (fresh
        # pixels, max separation).
        (_, ey, ex, v1), (_, iy, ix, _), _ = strokes
        ty1, tx1 = max(ey - 40, 10), max(ex - 40, 10)
        ty2, tx2 = min(iy + 30, h - 11), min(ix + 30, w - 11)
        for (sy, sx, val) in ((ty1, tx1, 192), (ty2, tx2, 0)):
            mask[sy - 10 : sy + 10, sx - 10 : sx + 10] = True
            value[sy - 10 : sy + 10, sx - 10 : sx + 10] = val
        m, v = jnp.asarray(mask), jnp.asarray(value)
        st_twin = tuple(jnp.array(s) for s in st_full)
        d_inc, st_twin = pipe.solve_incremental(
            gp, m, v, st_twin, jnp.asarray([ty1, tx1], jnp.int32)
        )
        d_inc, st_twin = pipe.solve_incremental(
            gp, m, v, st_twin, jnp.asarray([ty2, tx2], jnp.int32)
        )
        d_full, st_full = pipe.solve(gp, m, v, st_full)
        err = (np.asarray(d_inc) - np.asarray(d_full)) / 255.0
        band = (
            _seam_band(h, w, ty1, tx1, cfg.incremental_window)
            | _seam_band(h, w, ty2, tx2, cfg.incremental_window)
        )
        rows.append(
            dict(
                gs=gs,
                stroke="twin",
                rmse=float(np.sqrt(np.mean(err**2))),
                maxerr=float(np.abs(err).max()),
                seam=float(np.sqrt(np.mean(err[band] ** 2))),
            )
        )
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", default=None,
                   help="comma-separated pair names (default: all)")
    p.add_argument("--gs", default="0,2,4",
                   help="incremental_global_smooth values to sweep")
    p.add_argument("--window-levels", type=int, default=None,
                   help="override incremental_window_levels (how many fine "
                        "levels take the windowed solve; coarser levels "
                        "re-solve fully)")
    p.add_argument("--window", type=int, default=None,
                   help="override incremental_window (level-0 window side)")
    p.add_argument("--dataset", default=DATASET)
    p.add_argument("--synthetic", action="store_true",
                   help="also run the sparse-synthetic worst case "
                        "(tests/test_incremental.py geometry)")
    a = p.parse_args()
    gs_values = [int(s) for s in a.gs.split(",")]

    import jax

    jax.config.update("jax_platforms", "cpu")

    from realtimedepthdiffusion.io import imread_rgb, load_annotation

    img_dir = os.path.join(a.dataset, "images")
    names = sorted(
        os.path.splitext(f)[0] for f in os.listdir(img_dir) if f.endswith(".jpg")
    )
    if a.pairs:
        names = [n for n in names if n in set(a.pairs.split(","))]

    cfg_kw = {}
    if a.window_levels is not None:
        cfg_kw["incremental_window_levels"] = a.window_levels
    if a.window is not None:
        cfg_kw["incremental_window"] = a.window

    print("| pair | stroke | " + " | ".join(
        f"gs={g}: rmse / max / seam" for g in gs_values) + " |")
    print("|---|---|" + "---|" * len(gs_values))
    agg = {g: [] for g in gs_values}
    for name in names:
        rgb = imread_rgb(os.path.join(img_dir, f"{name}.jpg"))
        mask, value = load_annotation(
            os.path.join(a.dataset, "annotations", f"{name}.png")
        )
        rows = run_pair(rgb, mask, value, gs_values, cfg_kw)
        _print_pair(name, rows, gs_values, agg)
    if a.synthetic:
        from tests.conftest import synthetic_pair

        rgb, mask, value = synthetic_pair(420, 560, 7)
        rows = run_pair(rgb, mask, value, gs_values, cfg_kw)
        _print_pair("synthetic-sparse", rows, gs_values, agg)
    print("|---|---|" + "---|" * len(gs_values))
    worst = {g: (max(r["rmse"] for r in agg[g]),
                 max(r["maxerr"] for r in agg[g]),
                 max(r["seam"] for r in agg[g])) for g in gs_values}
    print("| **worst** | all | " + " | ".join(
        f"{worst[g][0]:.4f} / {worst[g][1]:.3f} / {worst[g][2]:.4f}"
        for g in gs_values) + " |")
    return 0


def _print_pair(name, rows, gs_values, agg):
    by_stroke = {}
    for r in rows:
        by_stroke.setdefault(r["stroke"], {})[r["gs"]] = r
        agg[r["gs"]].append(r)
    for stroke, per_gs in by_stroke.items():
        cells = " | ".join(
            f"{per_gs[g]['rmse']:.4f} / {per_gs[g]['maxerr']:.3f} / "
            f"{per_gs[g]['seam']:.4f}"
            for g in gs_values
        )
        print(f"| {name} | {stroke} | {cells} |")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
