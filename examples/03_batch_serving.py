"""Directory batch serving with the async host-IO pipeline.

`serve.solve_pairs` is the programmatic core of `rtdd-serve`: pairs are
matched by filename stem, one program is compiled per distinct image shape
(shape bucketing), and host PNG decode/encode runs on a thread pool that
overlaps the device solves (docs/USAGE.md §3). Outputs are bit-identical
to a sequential loop.
"""

# Allow running from a source checkout without `pip install -e .`:
# the script's own dir (examples/) is on sys.path, the repo root is not.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core import effects
from realtimedepthdiffusion.serve import discover_pairs, solve_pairs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", default="/root/reference/dataset/images")
    p.add_argument("--annotations", default="/root/reference/dataset/annotations")
    p.add_argument("--out", default="/tmp/rtdd_batch")
    p.add_argument("--limit", type=int, default=4, help="serve only the first N pairs")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--io-workers", type=int, default=4)
    p.add_argument("--prefetch", type=int, default=2)
    args = p.parse_args(argv)

    pairs = discover_pairs(args.images, args.annotations)[: args.limit]
    cfg = DiffusionConfig(max_iterations=args.iterations)
    written = solve_pairs(
        pairs,
        args.out,
        cfg,
        effect=effects.EFFECT_HAZE,
        progress=lambda img_path, out_path: print(f"{img_path} -> {out_path}"),
        io_workers=args.io_workers,
        prefetch=args.prefetch,
    )
    print(f"wrote {len(written)} depth maps to {args.out}")
    return written


if __name__ == "__main__":
    main()
