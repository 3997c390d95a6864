"""Interactive editing session: device-resident state machine.

Rebuild of the reference's main-loop state (src/main.cpp:20-27,
180-334) with the host round-trips redesigned: the reference paints on the
GPU, downloads to host after EVERY stroke, and re-uploads before every solve
(SURVEY.md §3.3). Here brush strokes hit host annotation planes through the
native C++ rasterizer (dirty-rect tracked, no device round trip at stroke
latency), the annotation uploads once per solve, and the gray pyramid +
depth-state pyramid stay device-resident for the whole session. A solve is
one compiled dispatch.

Key/mode semantics preserved exactly (SURVEY.md C6):
- digits '0'..'4' -> scribble depth min((d)*64, 254)
- '+'/'-'         -> brush radius +-2 (clamped at 0; quirk #6 fixed)
- 'd'             -> solve; --live solves every frame
- 'b'/'g'/'h'     -> sticky refocus/desaturation/haze (mutually exclusive)
- 's'             -> save AnnotatedImage.png, DepthMap.png, ArtisticEffect.png
- 't'             -> report last solve wall time
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import DiffusionConfig
from ..core import effects as fx
from ..io import depth_to_u8, depth_to_u16, imwrite, load_annotation, save_annotation
from ..native.runtime import Arena, NativeRuntime
from ..pipeline import DepthPipeline
from ..utils.timing import StageTimer

_KEY_EFFECT = {"b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION, "h": fx.EFFECT_HAZE}


class DepthSession:
    """One image-editing session (the lifetime of the reference's main())."""

    def __init__(self, rgb: np.ndarray, cfg: DiffusionConfig = DiffusionConfig()):
        self.cfg = cfg
        self.rows, self.cols = rgb.shape[:2]
        self.rgb_np = np.ascontiguousarray(rgb[..., :3], dtype=np.uint8)
        self.pipe = DepthPipeline(self.rows, self.cols, cfg)
        # fast_start: compile the staged first-solve programs on a
        # background thread WHILE the rest of this constructor compiles the
        # gray pyramid and uploads the image — the first solve then joins
        # an almost-finished compile instead of starting it (no-op when
        # fast_start is off).
        self.pipe.prewarm_async()
        self.rgb, self.gray_pyr = self.pipe.prepare_image(self.rgb_np)
        # Annotation planes live on HOST and are painted by the native
        # runtime's brush rasterizer (dirty-rect tracked); they upload to the
        # device once per solve — the same cadence as the reference's
        # upload at src/main.cpp:236-237, minus its paint-time downloads.
        self.native = NativeRuntime()
        # All host frame buffers for the session come from one native arena
        # slab: the two annotation planes plus the edited-image compositing
        # buffer the GUI redraws every tick. Views stay valid for the
        # session's lifetime (the session owns the arena).
        self.arena = Arena(2 * self.rows * self.cols + 3 * self.rows * self.cols + 4 * 64)
        self.mask_np = self.arena.alloc_u8((self.rows, self.cols))
        self.value_np = self.arena.alloc_u8((self.rows, self.cols))
        self._edited_buf = self.arena.alloc_u8((self.rows, self.cols, 3))
        # Pending edits as a LIST of disjoint dirty rects (y0, x0, y1, x1):
        # up to cfg.incremental_max_rects simultaneous distant strokes each
        # take the windowed incremental path (round-4 verdict task #5 — a
        # single bounding rect used to merge two-handed strokes into one
        # over-window rect and silently fall back to the full re-solve).
        self.dirty_rects: list = []
        self._mask_d: Optional[jnp.ndarray] = None  # device annotation cache
        self._value_d: Optional[jnp.ndarray] = None
        self.depth_state = self.pipe.initial_state()
        self.depth0 = self.depth_state[0]
        self.artistic: Optional[jnp.ndarray] = None
        self.effect = fx.EFFECT_NONE
        self.scribble_color = 0
        self.scribble_radius = cfg.brush_radius(self.rows, self.cols)
        # Export preference (--depth16): consulted by save() when the caller
        # does not pass depth16 explicitly, so the GUI 's' key honors the
        # flag the session was launched with.
        self.save_depth16 = False
        self.timer = StageTimer()
        self.last_solve_ms = 0.0
        self.solve_count = 0
        # Incremental pipeline: reduced iteration budget for warm re-solves
        # (cfg.incremental_iterations > 0). The depth-state warm start makes
        # a small budget sufficient after local edits.
        self._inc_pipe: Optional[DepthPipeline] = None
        if cfg.incremental_iterations > 0:
            import dataclasses

            inc_cfg = dataclasses.replace(
                cfg, max_iterations=cfg.incremental_iterations
            )
            self._inc_pipe = DepthPipeline(self.rows, self.cols, inc_cfg)
        # fast_start: the fused/incremental background compiles are kicked
        # by the pipeline AFTER the staged path is ready (pipeline.solve) —
        # kicking them first would make the small staged compiles compete
        # with the large fused compile for host cores.

    # ------------------------------------------------------------ annotation
    def load_annotation_file(self, path: str) -> None:
        """-a flag: resume a session from an annotation PNG (the checkpoint
        format, src/main.cpp:160-170)."""
        mask, value = load_annotation(path, self.cfg)
        if mask.shape != (self.rows, self.cols):
            raise ValueError(
                f"annotation {mask.shape} does not match image "
                f"{(self.rows, self.cols)}"
            )
        # copy into the arena-backed planes (they must keep their storage)
        np.copyto(self.mask_np, mask.astype(np.uint8))
        np.copyto(self.value_np, value)
        self.dirty = (0, 0, self.rows - 1, self.cols - 1)

    def set_color_key(self, digit: int) -> None:
        """Keys '0'..'4' (src/main.cpp:38-44)."""
        if 0 <= digit <= 4:
            self.scribble_color = min(digit * 64, 254)

    def adjust_radius(self, delta: int) -> None:
        self.scribble_radius = max(self.scribble_radius + delta, 0)

    @property
    def dirty(self) -> Optional[Tuple[int, int, int, int]]:
        """Bounding box of all pending dirty rects (the single-rect view;
        the multi-rect list is ``dirty_rects``)."""
        if not self.dirty_rects:
            return None
        ys0, xs0, ys1, xs1 = zip(*self.dirty_rects)
        return (min(ys0), min(xs0), max(ys1), max(xs1))

    @dirty.setter
    def dirty(self, rect) -> None:
        self.dirty_rects = [] if rect is None else [tuple(rect)]

    def _add_dirty(self, rect, gap: int = 8) -> None:
        """Insert a paint rect: merge with every pending rect it overlaps
        or sits within ``gap`` px of (consecutive events of one stroke
        coalesce into one rect; distant simultaneous strokes stay
        separate). Overflow beyond cfg.incremental_max_rects merges the
        two nearest rects, so the list is bounded and the worst case
        degrades to the old single-bounding-rect behavior."""
        def near(a, b):
            return not (a[2] + gap < b[0] or b[2] + gap < a[0]
                        or a[3] + gap < b[1] or b[3] + gap < a[1])

        def union(a, b):
            return (min(a[0], b[0]), min(a[1], b[1]),
                    max(a[2], b[2]), max(a[3], b[3]))

        rects = self.dirty_rects
        cur = tuple(rect)
        merged = True
        while merged:
            merged = False
            for i, r in enumerate(rects):
                if near(cur, r):
                    cur = union(cur, r)
                    rects.pop(i)
                    merged = True
                    break
        rects.append(cur)
        kmax = max(int(self.cfg.incremental_max_rects), 1)
        while len(rects) > kmax:
            best = None
            for i in range(len(rects)):
                for j in range(i + 1, len(rects)):
                    a, b = rects[i], rects[j]
                    d = (abs((a[0] + a[2]) - (b[0] + b[2]))
                         + abs((a[1] + a[3]) - (b[1] + b[3])))
                    if best is None or d < best[0]:
                        best = (d, i, j)
            _, i, j = best
            rects[i] = union(rects[i], rects[j])
            rects.pop(j)

    def paint(self, x: int, y: int) -> None:
        """Mouse-drag brush stroke (square brush, SURVEY.md C5): native
        rasterizer into the host planes, accumulating dirty rects."""
        rect = self.native.paint(
            self.mask_np, self.value_np, x, y, self.scribble_color,
            self.scribble_radius,
        )
        if rect is not None:
            self._add_dirty(rect)

    # ----------------------------------------------------------------- solve
    def solve(self) -> np.ndarray:
        """One solve; returns the uint8 depth map. Warm-starts from the
        previous depth-state pyramid like the reference's persistent device
        buffers.

        Incremental mode (cfg.incremental_iterations > 0): after the first
        full solve, edits whose dirty rects each fit the incremental window
        take the LOCAL path — the host uploads only the dirty windows of the
        annotation planes (device-side dynamic_update_slice) and the solver
        re-solves just a window around each edit at the fine levels
        (core/incremental.py), sequentially reusing ONE compiled
        single-window program with different centers (up to
        cfg.incremental_max_rects simultaneous distant strokes). Larger
        edits (annotation/checkpoint loads, rect overflow) fall back to the
        full warm re-solve.
        """
        t0 = time.perf_counter()
        pipe = self.pipe
        if self._inc_pipe is not None and self.solve_count > 0:
            pipe = self._inc_pipe

        rects = list(self.dirty_rects)
        centers = []
        use_local = False
        inc_kick_wanted = False
        if (
            self._inc_pipe is not None
            and self.solve_count > 0
            and rects
            and self._mask_d is not None
        ):
            s_win = min(self.cfg.incremental_window, self.rows, self.cols)
            kmax = max(int(self.cfg.incremental_max_rects), 1)
            use_local = len(rects) <= kmax and all(
                r[2] - r[0] + 1 <= s_win and r[3] - r[1] + 1 <= s_win
                for r in rects
            )
            # fast_start: never block a live frame on the incremental
            # program's compile — fall back to the (already compiled) full
            # warm re-solve until its background compile lands. PEEK here;
            # the kick happens after this frame's solve is dispatched
            # (pipeline.incremental_ready docstring).
            if use_local and not self.pipe.incremental_ready(
                self.effect if self.effect != fx.EFFECT_NONE else None,
                kick=False,
            ):
                use_local = False
                inc_kick_wanted = True

        with self.timer.stage("upload"):
            # The dirty rects gate (and crop) the host->device annotation
            # transfer: under --live the solve runs every frame, but
            # unchanged annotations reuse the device copies, and small
            # edits upload only the window bytes.
            if use_local:
                s_win = min(self.cfg.incremental_window, self.rows, self.cols)

                def origin(c, lo, hi, n, s=s_win):
                    # Window start near the rect center, clamped so the
                    # window COVERS the whole rect ([hi+1-s, lo]) and stays
                    # in-bounds; a centered start alone can miss the rect's
                    # last row/column when the rect spans exactly s pixels.
                    return min(max(c - s // 2, hi + 1 - s, 0), lo, n - s)

                for rect in rects:
                    cy = (rect[0] + rect[2]) // 2
                    cx = (rect[1] + rect[3]) // 2
                    oy = origin(cy, rect[0], rect[2], self.rows)
                    ox = origin(cx, rect[1], rect[3], self.cols)
                    mw = jnp.asarray(
                        self.mask_np[oy : oy + s_win, ox : ox + s_win]
                        .astype(bool)
                    )
                    vw = jnp.asarray(
                        self.value_np[oy : oy + s_win, ox : ox + s_win]
                    )
                    self._mask_d, self._value_d = (
                        self.pipe.update_annotation_window(
                            self._mask_d, self._value_d, mw, vw,
                            (jnp.int32(oy), jnp.int32(ox)),
                        )
                    )
                    centers.append(jnp.asarray([cy, cx], dtype=jnp.int32))
            elif self.dirty is not None or self._mask_d is None:
                self._mask_d = jnp.asarray(self.mask_np.astype(bool))
                self._value_d = jnp.asarray(self.value_np)
            mask_d, value_d = self._mask_d, self._value_d
            self.dirty = None
        with self.timer.stage("solve"):
            if use_local:
                # One windowed re-solve per rect, sequentially through the
                # SAME compiled program (center is a traced argument);
                # the active effect renders once, fused with the last
                # window's solve (it sees every rect's updated state).
                for i, center in enumerate(centers):
                    if self.effect == fx.EFFECT_NONE or i < len(centers) - 1:
                        self.depth0, self.depth_state = (
                            self.pipe.solve_incremental(
                                self.gray_pyr, mask_d, value_d,
                                self.depth_state, center,
                            )
                        )
                    else:
                        self.depth0, self.depth_state, self.artistic = (
                            self.pipe.solve_incremental_and_effect(
                                self.effect, self.gray_pyr, self.rgb, mask_d,
                                value_d, self.depth_state, center,
                            )
                        )
            elif self.effect == fx.EFFECT_NONE:
                self.depth0, self.depth_state = pipe.solve(
                    self.gray_pyr, mask_d, value_d, self.depth_state
                )
            else:
                self.depth0, self.depth_state, self.artistic = (
                    pipe.solve_and_effect(
                        self.effect, self.gray_pyr, self.rgb, mask_d,
                        value_d, self.depth_state,
                    )
                )
            u8 = np.asarray(self.pipe.depth_u8(self.depth0))
        if inc_kick_wanted:
            # Deferred kick: this frame's work (and its readback above) is
            # done; the incremental compile now rides behind it.
            self.pipe.incremental_ready(
                self.effect if self.effect != fx.EFFECT_NONE else None
            )
        self.solve_count += 1
        self.last_solve_ms = (time.perf_counter() - t0) * 1000.0
        return u8

    # --------------------------------------------------------------- effects
    def set_effect_key(self, key: str) -> None:
        """'b'/'g'/'h': sticky, mutually exclusive (src/main.cpp:190-230)."""
        eff = _KEY_EFFECT.get(key.lower())
        if eff is not None:
            self.effect = eff

    def render_effect(self) -> Optional[np.ndarray]:
        """Render the active effect from the current depth map."""
        if self.effect == fx.EFFECT_NONE:
            return None
        with self.timer.stage("effect"):
            depth = jnp.clip(self.depth0, 0.0, 255.0)
            self.artistic = self.pipe.effect(
                self.effect, self.rgb, self.gray_pyr[0], depth
            )
            return np.asarray(self.artistic)

    # --------------------------------------------------------------- display
    def edited_image(self) -> np.ndarray:
        """The scribble overlay view (the reference's 'Edited Image'),
        composited into the arena-backed display buffer (redrawn every GUI
        tick; reusing one slab avoids ~6 MB/frame of allocator churn)."""
        np.copyto(self._edited_buf, self.rgb_np)
        m = self.mask_np != 0
        self._edited_buf[m] = self.value_np[m][:, None]
        return self._edited_buf

    def depth_image(self) -> np.ndarray:
        return np.asarray(self.pipe.depth_u8(self.depth0))

    # ------------------------------------------------------------------ save
    def save(self, out_dir: str = ".",
             depth16: Optional[bool] = None) -> Tuple[str, ...]:
        """'s' key: the reference's three PNGs (src/main.cpp:297-318) — the
        annotated image doubles as the resumable checkpoint via
        save_annotation's sentinel encoding. ``depth16`` additionally writes
        DepthMap16.png, a 16-bit PNG at the solver's full precision
        (io.depth_to_u16) — an export the reference lacks; None defers to
        the session's ``save_depth16`` preference (the --depth16 flag)."""
        if depth16 is None:
            depth16 = self.save_depth16
        with self.timer.stage("save"):
            os.makedirs(out_dir, exist_ok=True)
            mask_np = self.mask_np.astype(bool)
            value_np = self.value_np
            p1 = os.path.join(out_dir, "AnnotatedImage.png")
            imwrite(p1, np.where(mask_np[..., None], value_np[..., None], self.rgb_np))
            save_annotation(
                os.path.join(out_dir, "Annotation.png"), mask_np, value_np, self.cfg
            )
            p2 = os.path.join(out_dir, "DepthMap.png")
            d8 = depth_to_u8(np.asarray(self.depth0))
            imwrite(p2, np.repeat(d8[..., None], 3, axis=2))
            p3 = os.path.join(out_dir, "ArtisticEffect.png")
            art = self.render_effect()
            imwrite(p3, art if art is not None else np.zeros_like(self.rgb_np))
            paths = (p1, p2, p3)
            if depth16:
                p4 = os.path.join(out_dir, "DepthMap16.png")
                imwrite(p4, depth_to_u16(np.asarray(self.depth0)))
                paths = paths + (p4,)
        return paths

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Full session checkpoint: annotation planes + the warm depth-state
        pyramid + cursor state. Superset of the reference's annotation-PNG
        checkpoint (src/main.cpp:297-318): resuming restores not only the
        scribbles but the converged multigrid state, so the next solve is
        warm from the first frame."""
        arrays = {
            "mask": self.mask_np,
            "value": self.value_np,
            "scribble_color": np.int32(self.scribble_color),
            "scribble_radius": np.int32(self.scribble_radius),
            "effect": np.int32(self.effect),
            "solve_count": np.int32(self.solve_count),
        }
        for i, d in enumerate(self.depth_state):
            arrays[f"depth_{i}"] = np.asarray(d)
        np.savez_compressed(path, **arrays)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if data["mask"].shape != (self.rows, self.cols):
            raise ValueError(
                f"checkpoint shape {data['mask'].shape} != image "
                f"{(self.rows, self.cols)}"
            )
        np.copyto(self.mask_np, data["mask"].astype(np.uint8))
        np.copyto(self.value_np, data["value"].astype(np.uint8))
        self.scribble_color = int(data["scribble_color"])
        self.scribble_radius = int(data["scribble_radius"])
        self.effect = int(data["effect"])
        self.solve_count = int(data["solve_count"])
        self.depth_state = tuple(
            jnp.asarray(data[f"depth_{i}"]) for i in range(len(self.depth_state))
        )
        self.depth0 = self.depth_state[0]
        self.dirty = (0, 0, self.rows - 1, self.cols - 1)

    def residual_report(self) -> str:
        """Per-level residual norms of the current depth state."""
        res = np.asarray(
            self.pipe.residuals(
                self.gray_pyr,
                jnp.asarray(self.mask_np.astype(bool)),
                jnp.asarray(self.value_np),
                self.depth_state,
            )
        )
        parts = [
            f"L{l}=max {mx:.4f}/rms {rm:.4f}"
            for l, (mx, rm) in enumerate(zip(res[0], res[1]))
        ]
        return "Residual (per level): " + "  ".join(parts)

    def timing_report(self) -> str:
        """'t' key: the last solve's wall time + per-stage breakdown (the
        observability the reference lacks, SURVEY.md §5)."""
        return (
            f"Processing Time: {self.last_solve_ms:.2f} ms\n{self.timer.report()}"
        )
