"""Generate the PARITY.md CUDA-faithful RMSE table over all 12 dataset pairs.

Usage:
    JAX_PLATFORMS=cpu python tools/parity_report.py

For each reference dataset pair this runs, at the FULL default schedule
(1000-iteration cascade):
  1. the CUDA-faithful oracle (oracle/faithful.py: real cv::pyrDown
     ceil-crop gray chain, cv::pyrUp depth upsampling — what the reference
     binary computes, see that module's docstring for the three remaining
     documented arithmetic deviations),
  2. the framework's floor-convention NumPy oracle,
  3. the shipped JAX pipeline (active backend),
and reports normalized-depth RMSE + max |delta| of (2) and (3) against (1),
plus the exact-match fraction of the exported uint8 maps.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import cv2  # noqa: E402

from realtimedepthdiffusion.config import DiffusionConfig  # noqa: E402
from realtimedepthdiffusion.oracle import faithful, numpy_ref as oracle  # noqa: E402


def rmse(a, b):
    return float(np.sqrt(np.mean(((a.astype(np.float64) - b) / 255.0) ** 2)))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from realtimedepthdiffusion.pipeline import DepthPipeline

    cfg = DiffusionConfig()
    rows = []
    for img_path in sorted(glob.glob("/root/reference/dataset/images/*.jpg")):
        name = os.path.splitext(os.path.basename(img_path))[0]
        ann_path = f"/root/reference/dataset/annotations/{name}.png"
        if not os.path.exists(ann_path):
            continue
        bgr = cv2.imread(img_path)
        plane = cv2.imread(ann_path, 0)
        mask = plane != 32
        value = np.where(mask, plane, 0).astype(np.uint8)
        h, w = bgr.shape[:2]

        d_faith, _ = faithful.solve_pyramid(bgr, mask, value, None, cfg)
        u8_faith = faithful.depth_u8(d_faith)

        rgb = np.ascontiguousarray(bgr[..., ::-1])
        d_floor, _ = oracle.solve_pyramid(oracle.rgb_to_gray(rgb), mask, value, None, cfg)

        pipe = DepthPipeline(h, w, cfg)
        _, gpyr = pipe.prepare_image(rgb)
        depth, _ = pipe.solve(
            gpyr, jnp.asarray(mask), jnp.asarray(value), pipe.initial_state()
        )
        depth = np.asarray(depth)
        u8_jax = np.asarray(pipe.depth_u8(jnp.asarray(depth)))

        row = {
            "pair": name,
            "size": f"{h}x{w}",
            "levels": cfg.num_levels(h, w),
            "rmse_jax": rmse(depth, d_faith),
            "max_jax": float(np.abs(depth - d_faith).max()),
            "rmse_floor_oracle": rmse(d_floor, d_faith),
            "u8_match": float((u8_jax == u8_faith).mean()),
        }
        rows.append(row)
        print(
            f"{name:14s} {row['size']:9s} L{row['levels']} "
            f"rmse_jax={row['rmse_jax']:.2e} max={row['max_jax']:.3f} "
            f"rmse_floor={row['rmse_floor_oracle']:.2e} "
            f"u8_match={row['u8_match']*100:.2f}%",
            flush=True,
        )

    out = {
        "backend": jax.default_backend(),
        "config": "default (full 1000-iteration cascade)",
        "bar": 1e-3,
        "pairs": rows,
        "worst_rmse_jax": max(r["rmse_jax"] for r in rows),
    }
    with open(os.path.join(os.path.dirname(__file__), "..", "PARITY.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nworst RMSE (jax vs faithful): {out['worst_rmse_jax']:.3e}  "
          f"(bar {out['bar']:.0e})")


if __name__ == "__main__":
    main()
