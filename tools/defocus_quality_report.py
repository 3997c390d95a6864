"""Error ledger for the bounded-error defocus ('approx' quality).

For every dataset pair this solves the depth map (default config), renders
the refocus effect with the EXACT candidate set and with the 'approx'
snapped set (config.pallas_defocus_quality — the 4K latency lever), and
tables the per-pair error: RMSE / max abs diff over the u8 output, and the
fraction of pixels whose window half was snapped at all. ``--size 4k``
bilinearly upscales image + depth to 2160x3840 first — the aperture regime
(max_half 110) the lever targets; a synthetic structured-content 4K case
rides along (worst-case content: hard edges under large blur windows).

Both arms run the XLA formulation (core/effects.defocus) on CPU; the
Pallas kernels are pinned bit-identical to it per quality setting by
tests/test_pallas.py, so this ledger is exactly the hardware kernels'
error. Output: a markdown table for PERF.md.

    JAX_PLATFORMS=cpu \
        python tools/defocus_quality_report.py [--size native|4k]
        [--strides 2,4,8] [--pairs Dog,Flower,...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATASET = "/root/reference/dataset"


def upscale(rgb: np.ndarray, depth: np.ndarray, h: int, w: int):
    from PIL import Image

    img = Image.fromarray(rgb).resize((w, h), Image.BILINEAR)
    dep = Image.fromarray(depth.astype(np.float32), mode="F").resize(
        (w, h), Image.BILINEAR
    )
    return np.asarray(img), np.asarray(dep)


def synthetic_4k(rng) -> tuple:
    """Structured 4K content: hard color edges + text-like stripes under a
    full near-to-far depth ramp — box-mean differences survive averaging
    (noise content would hide them)."""
    h, w = 2160, 3840
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
    rgb[..., 1] = np.linspace(255, 0, h, dtype=np.uint8)[:, None]
    for y in range(0, h, 240):
        rgb[y : y + 120, :, 2] = 255
    for x in range(0, w, 64):
        rgb[:, x : x + 8] = 255
    rgb[800:1400, 1500:2400] = (255, 0, 0)
    depth = np.broadcast_to(
        np.linspace(0, 255, w, dtype=np.float32)[None, :], (h, w)
    ).copy()
    depth[1000:1200, :] = 255.0  # far band at every column
    return rgb, depth


def measure(rgb: np.ndarray, depth: np.ndarray, strides) -> list:
    import jax.numpy as jnp

    from realtimedepthdiffusion.config import DiffusionConfig
    from realtimedepthdiffusion.core import effects as fx
    from realtimedepthdiffusion.core.effects import defocus_half_widths

    h, w = depth.shape
    cfg_e = DiffusionConfig(pallas_defocus_quality="exact")
    rgb_d, dep_d = jnp.asarray(rgb), jnp.asarray(np.clip(depth, 0.0, 255.0))
    exact = np.asarray(fx.defocus(rgb_d, dep_d, cfg_e)).astype(np.int32)
    half_e = np.asarray(defocus_half_widths(dep_d, h, w, cfg_e))
    rows = []
    for q in strides:
        cfg_a = DiffusionConfig(
            pallas_defocus_quality="approx", pallas_defocus_stride=q
        )
        approx = np.asarray(fx.defocus(rgb_d, dep_d, cfg_a)).astype(np.int32)
        half_a = np.asarray(defocus_half_widths(dep_d, h, w, cfg_a))
        snapped = half_e != half_a
        diff = np.abs(exact - approx)
        rows.append(
            dict(
                stride=q,
                max_half=int(half_e.max()),
                snapped_pct=100.0 * snapped.mean(),
                rmse=float(np.sqrt((diff.astype(np.float64) ** 2).mean())),
                maxdiff=int(diff.max()),
            )
        )
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", choices=["native", "4k"], default="4k",
                   help="measure at the pair's native size or upscaled to "
                        "2160x3840 (default: 4k, the regime the lever "
                        "targets)")
    p.add_argument("--strides", default="2,4,8",
                   help="comma-separated pallas_defocus_stride values")
    p.add_argument("--pairs", default=None,
                   help="comma-separated pair names (default: all 12)")
    p.add_argument("--dataset", default=DATASET)
    a = p.parse_args()
    strides = [int(s) for s in a.strides.split(",")]

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from realtimedepthdiffusion.io import imread_rgb, load_annotation
    from realtimedepthdiffusion.pipeline import DepthPipeline

    img_dir = os.path.join(a.dataset, "images")
    names = sorted(
        os.path.splitext(f)[0] for f in os.listdir(img_dir) if f.endswith(".jpg")
    )
    if a.pairs:
        names = [n for n in names if n in set(a.pairs.split(","))]

    print(f"| pair | max_half | stride | snapped px | RMSE (u8) | max |diff| |")
    print(f"|---|---|---|---|---|---|")
    agg = {q: [] for q in strides}

    def report(name, rgb, depth):
        for r in measure(rgb, depth, strides):
            agg[r["stride"]].append(r)
            print(
                f"| {name} | {r['max_half']} | {r['stride']} | "
                f"{r['snapped_pct']:.1f}% | {r['rmse']:.3f} | {r['maxdiff']} |"
            )

    rng = np.random.default_rng(0)
    for name in names:
        rgb = imread_rgb(os.path.join(img_dir, f"{name}.jpg"))
        mask, value = load_annotation(
            os.path.join(a.dataset, "annotations", f"{name}.png")
        )
        h, w = rgb.shape[:2]
        pipe = DepthPipeline(h, w)
        _, gpyr = pipe.prepare_image(rgb)
        depth, _ = pipe.solve(
            gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state()
        )
        depth = np.asarray(depth)
        if a.size == "4k":
            rgb, depth = upscale(rgb, depth, 2160, 3840)
        report(name, rgb, depth)

    rgb_s, depth_s = synthetic_4k(rng)
    if a.size != "4k":
        rgb_s, depth_s = rgb_s[:540, :960], depth_s[:540, :960]
    report("synthetic-edges", rgb_s, depth_s)

    for q in strides:
        rows = agg[q]
        if not rows:
            continue
        rmse = float(np.sqrt(np.mean([r["rmse"] ** 2 for r in rows])))
        print(
            f"| **aggregate** | — | {q} | "
            f"{np.mean([r['snapped_pct'] for r in rows]):.1f}% | "
            f"{rmse:.3f} | {max(r['maxdiff'] for r in rows)} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
