"""End-to-end compiled pipeline with per-shape program caching.

One ``DepthPipeline`` per (image size, config) compiles:
- ``solve``:   annotation pyramids -> seeding -> cascadic (or V-cycle)
               multigrid solve -> new depth-state pyramid   (ONE XLA program)
- ``effect_*``: the three depth effects, each fused with the uint8 readout
- ``solve_and_effect``: solve + effect in a single program (the
  BASELINE.json north-star fusion)

The reference re-uploads host state and re-launches ~2000 kernels per solve
(SURVEY.md §3.2-3.3); here device arrays are the source of truth and a solve
is exactly one dispatch.
"""

from __future__ import annotations

import atexit
import functools
import logging
import time
import weakref
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.multigrid import (
    build_gray_pyramid,
    initial_depth_state,
    solve_cascade,
    solve_vcycle,
)

# Background compile threads are daemon so nothing *during* the session ever
# blocks on them — but letting the interpreter finalize while one is inside
# an XLA compile aborts the whole process (CPython kills daemon threads via
# pthread_exit when they next touch the GIL; the forced unwind crossing
# XLA's C++ frames trips "FATAL: exception not rethrown" → SIGABRT, observed
# deterministically on exit-right-after-first-solve, tests/test_fast_start.py
# regression). XLA compiles cannot be cancelled, so the atexit hook — which
# runs on the main thread BEFORE finalization — joins whatever is still in
# flight. Bounded at 600 s in all so a wedged compile degrades to the old
# behavior instead of hanging exit forever.
_LIVE_COMPILE_THREADS: "weakref.WeakSet" = weakref.WeakSet()


def _join_background_compiles() -> None:
    pending = [t for t in _LIVE_COMPILE_THREADS if t.is_alive()]
    if not pending:
        return
    logging.getLogger(__name__).info(
        "exit: waiting for %d in-flight background XLA compile(s) "
        "(uncancellable; call pipeline.wait_fused() or use rtdd-warmup to "
        "avoid paying this at exit)", len(pending)
    )
    # One global deadline, not per-thread: the compiles run concurrently,
    # so exit is bounded at 600 s total no matter how many shapes kicked.
    deadline = time.monotonic() + 600.0
    for t in pending:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))


atexit.register(_join_background_compiles)


class _StagedCascade:
    """The cascade split into per-level XLA programs — the fast cold-start
    path (cfg.fast_start).

    The fused whole-cascade program is the steady-state optimum (one
    dispatch per solve) but its single large XLA module is the slowest
    compile of a session; the SAME computation split at the level
    boundaries compiles as small modules in parallel. The split points
    carry no
    arithmetic (pyrUp/seed feed the next level's program unchanged), so
    staged and fused outputs are bit-identical (tests/test_fast_start.py);
    the only cost is ~L+1 dispatches per solve instead of one — irrelevant
    for the handful of frames before the fused executable lands.
    """

    def __init__(self, rows: int, cols: int, cfg: DiffusionConfig):
        from .core.annotation import annotation_pyr_down, seed_depth
        from .core.pyramid import pyr_up
        from .ops import dispatch as _dispatch

        self.rows, self.cols, self.cfg = rows, cols, cfg
        levels = cfg.num_levels(rows, cols)
        self.levels = levels
        L = levels - 1
        sizes = [cfg.level_size(rows, cols, l) for l in range(levels)]

        def prep(mask0, value0, state_l):
            # Annotation pyramids + the coarsest-level seed, exactly as in
            # solve_cascade's prologue.
            masks, values = [mask0], [value0]
            for l in range(1, levels):
                m, v = annotation_pyr_down(masks[-1], values[-1], sizes[l])
                masks.append(m)
                values.append(v)
            seeded = seed_depth(state_l, masks[L], values[L])
            return tuple(masks), tuple(values), seeded

        self._prep = jax.jit(prep)

        def level_fn(level):
            iters = cfg.level_iterations(levels, level)
            if level == 0:
                def f0(state, mask, gray):
                    return _dispatch.solve_level(
                        state, mask, gray, 0, L, iters, cfg
                    )
                return jax.jit(f0)

            def fl(state, mask, gray, mask_next, value_next):
                out = _dispatch.solve_level(
                    state, mask, gray, level, L, iters, cfg
                )
                up = pyr_up(out, sizes[level - 1])
                return out, seed_depth(up, mask_next, value_next)

            return jax.jit(fl)

        self._level_fns = [level_fn(l) for l in range(levels)]
        self._compiled = False

    def lower_all(self) -> list:
        """Trace + lower every staged program ON THE CALLING THREAD and
        return the Lowered objects (compile_from's input). Tracing/lowering
        is pure-Python jaxpr work and is NOT safe to run concurrently with
        other traces (a background lower racing a main-thread trace
        produced a malformed jaxpr — KeyError on a schedule constant,
        observed in examples/02); only the XLA .compile() step, which
        releases the GIL and is thread-safe, goes to worker threads."""
        cfg, rows, cols = self.cfg, self.rows, self.cols
        L = self.levels - 1
        sizes = [cfg.level_size(rows, cols, l) for l in range(self.levels)]
        sds = jax.ShapeDtypeStruct
        mask0 = sds((rows, cols), jnp.bool_)
        value0 = sds((rows, cols), jnp.uint8)
        state_l = sds(sizes[L], jnp.float32)
        masks_s, values_s, _ = jax.eval_shape(self._prep, mask0, value0, state_l)
        lowered = [self._prep.lower(mask0, value0, state_l)]
        for l in range(self.levels):
            args = [
                sds(sizes[l], jnp.float32),
                masks_s[l],
                sds(sizes[l], jnp.uint8),
            ]
            if l > 0:
                args += [masks_s[l - 1], values_s[l - 1]]
            lowered.append(self._level_fns[l].lower(*args))
        return lowered

    def compile_from(self, lowered: list) -> float:
        """Compile pre-lowered staged programs concurrently (XLA compiles
        release the GIL and are independent). Safe on any thread. Returns
        wall seconds. Idempotent."""
        import time
        from concurrent.futures import ThreadPoolExecutor

        if self._compiled:
            return 0.0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=self.levels + 1) as ex:
            for f in [ex.submit(lo.compile) for lo in lowered]:
                f.result()
        self._compiled = True
        return time.perf_counter() - t0

    def compile_parallel(self) -> float:
        """lower_all (this thread) + compile_from (parallel). Idempotent."""
        if self._compiled:
            return 0.0
        return self.compile_from(self.lower_all())

    def warm_execute(self) -> None:
        """Execute every staged program once on zero inputs and fetch one
        output, forcing the device to LOAD the executables now. Compiling
        is not loading: the first execution of each program pays its load,
        so the prewarm thread front-loads the loads into the session-init
        overlap window. No tracing happens here
        (compile_from populated the jit call caches — measured: first call
        after AOT compile is milliseconds), so this is thread-safe."""
        import numpy as np

        cfg, rows, cols = self.cfg, self.rows, self.cols
        sizes = [cfg.level_size(rows, cols, l) for l in range(self.levels)]
        gp = tuple(jnp.zeros(s, jnp.uint8) for s in sizes)
        st = tuple(jnp.zeros(s, jnp.float32) for s in sizes)
        m = jnp.zeros((rows, cols), jnp.bool_)
        v = jnp.zeros((rows, cols), jnp.uint8)
        d, _ = self(gp, m, v, st)
        np.asarray(d)

    def __call__(self, gray_pyr, mask0, value0, depth_state):
        L = self.levels - 1
        masks, values, seeded = self._prep(mask0, value0, depth_state[L])
        state = list(depth_state)
        state[L] = seeded
        for level in range(L, 0, -1):
            state[level], state[level - 1] = self._level_fns[level](
                state[level], masks[level], gray_pyr[level],
                masks[level - 1], values[level - 1],
            )
        state[0] = self._level_fns[0](state[0], masks[0], gray_pyr[0])
        return state[0], tuple(state)


class DepthPipeline:
    """Compiled solve/effect programs for one image size + config.

    Stateless w.r.t. the image: callers pass (and carry) the depth-state
    pyramid, which warm-starts subsequent solves exactly like the
    reference's persistent deviceDepthImage pyramid (src/main.cpp:135-136).

    Cold start (cfg.fast_start, default on): the first solve(s) run the
    bit-identical staged per-level path (_StagedCascade) while the fused
    program compiles on a background thread; see solve().
    """

    def __init__(self, rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig()):
        self.rows, self.cols, self.cfg = rows, cols, cfg
        self.levels = cfg.num_levels(rows, cols)
        driver = solve_vcycle if cfg.multigrid == "vcycle" else solve_cascade

        def _solve(gray_pyr, mask0, value0, depth_state):
            return driver(gray_pyr, mask0, value0, depth_state, cfg)

        # donate depth_state: the solver consumes and replaces it in place.
        self._solve = jax.jit(_solve, donate_argnums=(3,))

        def _solve_and_effect(effect, gray_pyr, rgb, mask0, value0, depth_state):
            depth0, state = driver(gray_pyr, mask0, value0, depth_state, cfg)
            # Effects consume display-range depth (the unclamped Chebyshev
            # extrapolation can overshoot [0,255] slightly) — same clip as
            # every unfused call site.
            out = fx.apply_effect(
                effect, rgb, gray_pyr[0], jnp.clip(depth0, 0.0, 255.0), cfg
            )
            return depth0, state, out

        self._solve_and_effect = jax.jit(
            _solve_and_effect, static_argnums=(0,), donate_argnums=(5,)
        )

        def _solve_incremental(gray_pyr, mask0, value0, depth_state, center):
            from .core.incremental import solve_incremental

            return solve_incremental(gray_pyr, mask0, value0, depth_state, center, cfg)

        self._solve_incremental = jax.jit(_solve_incremental, donate_argnums=(3,))

        def _solve_incremental_and_effect(effect, gray_pyr, rgb, mask0, value0,
                                          depth_state, center):
            from .core.incremental import solve_incremental

            depth0, state = solve_incremental(
                gray_pyr, mask0, value0, depth_state, center, cfg
            )
            out = fx.apply_effect(
                effect, rgb, gray_pyr[0], jnp.clip(depth0, 0.0, 255.0), cfg
            )
            return depth0, state, out

        self._solve_incremental_and_effect = jax.jit(
            _solve_incremental_and_effect, static_argnums=(0,), donate_argnums=(5,)
        )

        def _update_annotation_window(mask_d, value_d, mask_win, value_win, origin):
            # Device-side dirty-window annotation update: the host uploads
            # only the window bytes instead of two full planes.
            return (
                jax.lax.dynamic_update_slice(mask_d, mask_win, origin),
                jax.lax.dynamic_update_slice(value_d, value_win, origin),
            )

        self._update_annotation_window = jax.jit(_update_annotation_window)
        self._effect = jax.jit(
            lambda effect, rgb, gray, depth: fx.apply_effect(effect, rgb, gray, depth, cfg),
            static_argnums=(0,),
        )
        self._gray_pyramid = jax.jit(lambda g: build_gray_pyramid(g, cfg))
        self._to_u8 = jax.jit(
            lambda d: jnp.clip(jnp.rint(d), 0, 255).astype(jnp.uint8)
        )
        # Same float32 multiply as io.depth_to_u16's host form, so device
        # and host conversions agree bit-for-bit.
        self._to_u16 = jax.jit(
            lambda d: jnp.clip(jnp.rint(d * jnp.float32(257.0)), 0, 65535).astype(
                jnp.uint16
            )
        )

        def _residuals(gray_pyr, mask0, value0, depth_state):
            # Per-level residuals of the current depth state, both norms
            # (max row 0, rms row 1) — the convergence observability the
            # reference lacks (its deviceError buffer is dead, SURVEY.md
            # quirk #2). Showing both explains early-exit behavior: the
            # rms is what cfg.residual_metric='rms' gates on.
            from .core.multigrid import build_annotation_pyramids
            from .core.solver import residual_norm, residual_rms
            from .core.weights import edge_weights

            masks, _ = build_annotation_pyramids(mask0, value0, cfg)
            L = len(gray_pyr) - 1
            res = []
            for l in range(len(gray_pyr)):
                wts = edge_weights(gray_pyr[l], depth_state[l], l, L, cfg)
                res.append(jnp.stack([
                    residual_norm(depth_state[l], masks[l], wts),
                    residual_rms(depth_state[l], masks[l], wts),
                ]))
            return jnp.stack(res, axis=1)

        self._residuals = jax.jit(_residuals)

        # --- Cold-start machinery (cfg.fast_start): staged first solve +
        #     background fused compile. ---
        import threading

        self._staged: Optional[_StagedCascade] = None
        self._staged_lock = threading.Lock()
        self._staged_thread: Optional[threading.Thread] = None
        self._aot: dict = {}          # program key -> AOT executable
        self._compile_threads: dict = {}
        self._fast = cfg.fast_start and cfg.multigrid != "vcycle"
        # One-shot processes (headless --solve-and-exit) should set this
        # False: they exit before a background compile could ever serve a
        # solve, and the orphaned in-flight compile needlessly holds host
        # cores. Long-lived surfaces (GUI, --live, serving) leave it True.
        # RTDD_BACKGROUND_COMPILE=0 disables it process-wide.
        import os as _os

        self.background_compile = _os.environ.get(
            "RTDD_BACKGROUND_COMPILE", "1"
        ).lower() not in ("0", "false")
        # Fused kick deferral: the FIRST staged solve reaches its readback
        # before any background compile starts competing with it for host
        # cores; solve() kicks from the second staged solve on.
        self._staged_solves = 0

    # -- cold start -------------------------------------------------------
    def _solve_structs(self):
        sds = jax.ShapeDtypeStruct
        cfg, rows, cols = self.cfg, self.rows, self.cols
        sizes = [cfg.level_size(rows, cols, l) for l in range(self.levels)]
        gray_pyr = tuple(sds(s, jnp.uint8) for s in sizes)
        mask0 = sds((rows, cols), jnp.bool_)
        value0 = sds((rows, cols), jnp.uint8)
        state = tuple(sds(s, jnp.float32) for s in sizes)
        return gray_pyr, mask0, value0, state

    @functools.cached_property
    def _solve_sig(self):
        # Expected (shape, dtype) leaves, computed once: the AOT-routing
        # check runs on EVERY solve for the pipeline's lifetime, so it must
        # not rebuild the struct pytree per frame.
        return self._leaf_sig(self._solve_structs())

    @functools.cached_property
    def _solve_fx_sig(self):
        gp, m0, v0, st = self._solve_structs()
        return self._leaf_sig((gp, self._rgb_struct(), m0, v0, st))

    @functools.cached_property
    def _inc_sig(self):
        return self._leaf_sig(
            self._solve_structs() + (jax.ShapeDtypeStruct((2,), jnp.int32),)
        )

    @functools.cached_property
    def _inc_fx_sig(self):
        gp, m0, v0, st = self._solve_structs()
        return self._leaf_sig((gp, self._rgb_struct(), m0, v0, st,
                               jax.ShapeDtypeStruct((2,), jnp.int32)))

    @staticmethod
    def _leaf_sig(tree) -> tuple:
        return tuple(
            (l.shape, jnp.dtype(l.dtype))
            for l in jax.tree_util.tree_leaves(tree)
        )

    @staticmethod
    def _avals_match(sig, args) -> bool:
        """``sig``: a precomputed _leaf_sig tuple of (shape, dtype) pairs."""
        flat_a = jax.tree_util.tree_leaves(args)
        return len(sig) == len(flat_a) and all(
            s == (a.shape, a.dtype) for s, a in zip(sig, flat_a)
        )

    def _ensure_staged(self) -> "_StagedCascade":
        # Published already (prewarm compiles land under the lock BEFORE
        # its warm-load pass)? Use it now — the first solve's executes then
        # queue right behind the warm loads instead of joining the whole
        # prewarm thread (whose final fetch can take as long as the loads).
        with self._staged_lock:
            if self._staged is not None:
                return self._staged
        # Compiles still in flight (or prewarm failed): join, then either
        # take the published result or recompile so the failure raises in
        # the caller's context.
        t = self._staged_thread
        if t is not None and t.is_alive():
            t.join()
        with self._staged_lock:
            if self._staged is None:
                staged = _StagedCascade(self.rows, self.cols, self.cfg)
                staged.compile_parallel()
                self._staged = staged  # publish only fully compiled
            return self._staged

    def prewarm_async(self) -> None:
        """fast_start: trace+lower the staged first-solve programs NOW (on
        this thread — tracing must never run concurrently with the caller's
        other traces) and compile them on a background thread, so the rest
        of session setup — the gray-pyramid compile in prepare_image, image
        uploads, annotation load — overlaps the compiles instead of the
        first solve paying the whole set serially.
        Idempotent; no-op when fast_start is off. The first solve joins via
        _ensure_staged. Unlike the fused background compile this is NOT
        gated by self.background_compile: the staged programs are needed
        synchronously by the first solve either way, so starting them early
        only moves existing work."""
        import threading

        if not self._fast or self._staged is not None:
            return
        if self._staged_thread is not None and self._staged_thread.is_alive():
            return
        staged = _StagedCascade(self.rows, self.cols, self.cfg)
        try:
            lowered = staged.lower_all()  # caller thread: tracing is here
            # The u8 readout rides every first frame too; lower it here,
            # compile+load it in the thread with the rest.
            low_u8 = self._to_u8.lower(
                jax.ShapeDtypeStruct((self.rows, self.cols), jnp.float32)
            )
        except Exception:
            logging.getLogger(__name__).exception(
                "staged prewarm failed to lower (the first solve will "
                "retry and surface the error)"
            )
            return

        def work():
            try:
                staged.compile_from(lowered)
                low_u8.compile()
                with self._staged_lock:
                    if self._staged is None:
                        self._staged = staged
            except Exception:
                logging.getLogger(__name__).exception(
                    "staged prewarm failed (the first solve will retry "
                    "and surface the error)"
                )
                return
            try:
                # Force the device to LOAD the executables now (loading is
                # not compiling; warm_execute docstring). Failure here is
                # harmless — the first solve just pays the loads itself.
                staged.warm_execute()
                np.asarray(self._to_u8(
                    jnp.zeros((self.rows, self.cols), jnp.float32)
                ))
            except Exception:
                logging.getLogger(__name__).exception("prewarm load failed")

        t = threading.Thread(target=work, daemon=True, name="rtdd-prewarm")
        self._staged_thread = t
        _LIVE_COMPILE_THREADS.add(t)  # joined by the atexit hook above
        t.start()

    def _kick(self, key, lower_fn) -> None:
        """Start a background AOT compile; the executable lands in
        self._aot[key] when done. Idempotent per key. The trace+lower step
        runs HERE, on the calling thread — JAX tracing is not safe to run
        concurrently with the caller's own later traces (a background
        lower racing the main thread's incremental-program trace produced
        a malformed jaxpr, examples/02 regression). Only the thread-safe, GIL-releasing XLA
        .compile() goes to the background thread. A failed background
        compile only logs: the staged/jit path stays correct, and the
        failure resurfaces loudly wherever the fused path is forced."""
        import threading

        if key in self._compile_threads or not self.background_compile:
            return
        try:
            lowered = lower_fn()  # trace+lower on the caller thread
        except Exception:
            logging.getLogger(__name__).exception(
                "background compile failed to lower: %r", key
            )
            return

        def work():
            try:
                self._aot[key] = lowered.compile()
            except Exception:
                logging.getLogger(__name__).exception(
                    "background compile failed: %r", key
                )

        t = threading.Thread(target=work, daemon=True,
                             name=f"rtdd-compile-{key}")
        self._compile_threads[key] = t
        _LIVE_COMPILE_THREADS.add(t)  # joined by the atexit hook above
        t.start()

    def _rgb_struct(self):
        return jax.ShapeDtypeStruct((self.rows, self.cols, 3), jnp.uint8)

    def _kick_fused_compile(self, effect: Optional[int] = None) -> None:
        """Background-compile the fused solve (or solve+effect) program."""
        structs = self._solve_structs()
        if effect is None:
            self._kick(
                ("solve",), lambda: self._solve.lower(*structs)
            )
        else:
            gp, m0, v0, st = structs
            self._kick(
                ("solve_fx", effect),
                lambda: self._solve_and_effect.lower(
                    effect, gp, self._rgb_struct(), m0, v0, st
                ),
            )

    def _kick_incremental_compile(self, effect: Optional[int] = None) -> None:
        """Background-compile the incremental (windowed live re-solve)
        program so the first paint stroke never blocks on it."""
        gp, m0, v0, st = self._solve_structs()
        center = jax.ShapeDtypeStruct((2,), jnp.int32)
        if effect is None:
            self._kick(
                ("inc",),
                lambda: self._solve_incremental.lower(gp, m0, v0, st, center),
            )
        else:
            self._kick(
                ("inc_fx", effect),
                lambda: self._solve_incremental_and_effect.lower(
                    effect, gp, self._rgb_struct(), m0, v0, st, center
                ),
            )

    def incremental_ready(self, effect: Optional[int] = None,
                          kick: bool = True) -> bool:
        """fast_start: report whether the incremental program's background
        compile has landed (kicking it if not yet started), so the live loop
        can keep using the already-compiled full re-solve instead of
        blocking a frame on the incremental compile. The kicking frame pays
        the program's trace+lower (sub-second; tracing must stay on this
        thread — _kick docstring) but never the multi-second XLA compile.
        ``kick=False`` only peeks: the live loop peeks BEFORE dispatching
        its fallback solve and kicks AFTER, so the frame's work is enqueued
        ahead of the compile (same ordering rule as solve()'s fused kick).
        Always True when
        fast_start is off OR background compiles are disabled
        (RTDD_BACKGROUND_COMPILE=0 / one-shot surfaces): _kick would no-op
        then, so waiting on it would demote an explicitly requested
        --incremental to the full re-solve for the whole session; instead
        the first stroke pays the plain-jit compile synchronously, exactly
        like fast_start off."""
        if not self._fast or not self.background_compile:
            return True
        key = ("inc",) if effect is None else ("inc_fx", effect)
        if key in self._aot:
            return True
        if kick:
            self._kick_incremental_compile(effect)
        return False

    def wait_fused(self, timeout: Optional[float] = None) -> bool:
        """Block until pending background fused compiles finish (warmup /
        test hook). Returns True when none are still running."""
        for t in list(self._compile_threads.values()):
            t.join(timeout)
        return not any(t.is_alive() for t in self._compile_threads.values())

    # -- setup -----------------------------------------------------------
    def prepare_image(self, rgb_u8: np.ndarray):
        """Upload the image once; returns (rgb_dev, gray_pyramid)."""
        rgb = jnp.asarray(rgb_u8, dtype=jnp.uint8)
        gray0 = rgb_to_gray(rgb)
        return rgb, self._gray_pyramid(gray0)

    def initial_state(self) -> Tuple[jnp.ndarray, ...]:
        return initial_depth_state(self.rows, self.cols, self.cfg)

    # -- the critical path -------------------------------------------------
    def solve(self, gray_pyr, mask0, value0, depth_state):
        """Full multigrid solve; returns (depth0_f32, new_depth_state).

        fast_start routing: while the fused one-dispatch program is still
        compiling on the background thread, solves run the bit-identical
        staged per-level path (small programs that compile in parallel,
        far sooner than the fused module); once the AOT executable lands,
        solves switch to it."""
        if self._fast:
            args = (gray_pyr, mask0, value0, depth_state)
            ex = self._aot.get(("solve",))
            if ex is not None:
                if self._avals_match(self._solve_sig, args):
                    return ex(*args)
                return self._solve(*args)  # unusual dtypes: plain jit path
            # Staged compiles FIRST; the fused kick waits for the SECOND
            # staged solve, so the first frame's readback never competes
            # with a background compile.
            staged = self._ensure_staged()
            out = staged(*args)
            self._staged_solves += 1
            if self._staged_solves >= 2:
                self._kick_fused_compile(None)
            return out
        return self._solve(gray_pyr, mask0, value0, depth_state)

    def solve_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0, depth_state):
        """Fused solve + effect; returns (depth0, new_state, effect_rgb_u8).
        fast_start: staged solve + the standalone effect program until the
        fused executable lands (see solve())."""
        if self._fast:
            args = (gray_pyr, rgb, mask0, value0, depth_state)
            ex = self._aot.get(("solve_fx", effect))
            if ex is not None:
                if self._avals_match(self._solve_fx_sig, args):
                    return ex(*args)
                return self._solve_and_effect(effect, *args)
            staged = self._ensure_staged()  # before the fused kick, as above
            depth0, state = staged(gray_pyr, mask0, value0, depth_state)
            # The standalone effect program compiles at this first call;
            # keep it ahead of the fused kick too.
            out = self._effect(
                effect, rgb, gray_pyr[0], jnp.clip(depth0, 0.0, 255.0)
            )
            self._staged_solves += 1
            if self._staged_solves >= 2:  # see solve(): kick deferral
                self._kick_fused_compile(effect)
            return depth0, state, out
        return self._solve_and_effect(effect, gray_pyr, rgb, mask0, value0, depth_state)

    def solve_incremental(self, gray_pyr, mask0, value0, depth_state, center_yx):
        """Localized warm re-solve around an edit (core/incremental.py);
        returns (depth0, new_state). ``center_yx``: (2,) int32, L0 coords.
        fast_start: uses the background-compiled executable when it has
        landed (incremental_ready); otherwise compiles synchronously."""
        args = (gray_pyr, mask0, value0, depth_state, center_yx)
        ex = self._aot.get(("inc",))
        if ex is not None and self._avals_match(self._inc_sig, args):
            return ex(*args)
        return self._solve_incremental(*args)

    def solve_incremental_and_effect(self, effect: int, gray_pyr, rgb, mask0,
                                     value0, depth_state, center_yx):
        args = (gray_pyr, rgb, mask0, value0, depth_state, center_yx)
        ex = self._aot.get(("inc_fx", effect))
        if ex is not None and self._avals_match(self._inc_fx_sig, args):
            return ex(*args)
        return self._solve_incremental_and_effect(effect, *args)

    def update_annotation_window(self, mask_d, value_d, mask_win, value_win, origin):
        """Upload only a dirty window into the device annotation planes."""
        return self._update_annotation_window(
            mask_d, value_d, mask_win, value_win, origin
        )

    def effect(self, effect: int, rgb, gray0, depth0):
        return self._effect(effect, rgb, gray0, depth0)

    def depth_u8(self, depth0) -> jnp.ndarray:
        """float32 depth -> uint8 display/export (convertTo(CV_8UC1),
        src/main.cpp:290)."""
        return self._to_u8(depth0)

    def depth_u16(self, depth0) -> jnp.ndarray:
        """float32 depth -> uint16 full-precision export (io.depth_to_u16
        semantics), converted ON DEVICE so the 16-bit serving readback stays
        2 bytes/px instead of fetching f32."""
        return self._to_u16(depth0)

    def residuals(self, gray_pyr, mask0, value0, depth_state) -> jnp.ndarray:
        """Per-level residuals of a depth state, shape (2, levels): row 0
        max-norm, row 1 rms (coarse last)."""
        return self._residuals(gray_pyr, mask0, value0, depth_state)


@functools.lru_cache(maxsize=8)
def get_pipeline(rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig()) -> DepthPipeline:
    """Shape-keyed pipeline cache (cfg is hashable: frozen dataclass)."""
    return DepthPipeline(rows, cols, cfg)
