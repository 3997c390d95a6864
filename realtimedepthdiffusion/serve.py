"""Offline batch serving: solve depth maps for many (image, annotation)
pairs.

The reference is a strictly interactive desktop app; this module is the
framework's production-serving face: shape-bucketed compiled pipelines, an
optional data-parallel+spatially-sharded multi-chip path
(parallel.batched_step), and PNG export per pair.

    python -m realtimedepthdiffusion.serve \
        --pairs img1.jpg:ann1.png img2.jpg:ann2.png --out out/ [--effect h]

or directory mode (images matched to annotations by stem):

    python -m realtimedepthdiffusion.serve \
        --images dataset/images --annotations dataset/annotations --out out/

Multi-chip mode (--multichip [--batch B]) drives the data-parallel +
spatially-sharded batched step (parallel/sharded.py) over the full device
mesh: pairs are shape-bucketed, assembled into fixed-size batches (the last
batch padded to keep one compiled program per shape), and each batch is ONE
dispatch that solves B images across all chips:

    python -m realtimedepthdiffusion.serve \
        --images dataset/images --annotations dataset/annotations \
        --out out/ --multichip --batch 8 --effect b

Watch mode (--watch) turns the batch runner into a long-lived service:
the directories are polled (--poll-interval) and any NEW pair, or a pair
whose image/annotation mtime changed, is solved as it appears. Per-shape
compiled pipelines stay resident across batches, so after the first pair
of a shape every later pair of that shape pays only upload+solve+readback
— the serving analog of the reference's resident interactive session
(src/main.cpp:180-341 keeps one allocated GPU context across edits):

    python -m realtimedepthdiffusion.serve \
        --images inbox/images --annotations inbox/annotations \
        --out out/ --watch [--idle-exit 300] [--report manifest.json]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import VALID_RESIDUAL_METRICS, DiffusionConfig
from .core import effects as fx
from .io import (
    depth_to_u8,
    depth_to_u16,
    image_size,
    imread_rgb,
    imwrite,
    load_annotation,
)

_EFFECT_BY_KEY = {"b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION, "h": fx.EFFECT_HAZE}


def discover_pairs(images_dir: str, annotations_dir: str) -> List[Tuple[str, str]]:
    """Match images to annotations by filename stem (the dataset layout,
    SURVEY.md C21)."""
    anns = {}
    for f in os.listdir(annotations_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".png", ".jpg", ".jpeg"):
            anns[stem] = os.path.join(annotations_dir, f)
    pairs = []
    for f in sorted(os.listdir(images_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".png", ".jpg", ".jpeg") and stem in anns:
            pairs.append((os.path.join(images_dir, f), anns[stem]))
    return pairs


def _outputs_done(a, img_path: str) -> bool:
    """True when EVERY output the run was asked for already exists in
    a.out — a resume that adds --effect (or --depth16) must re-solve pairs
    missing that output, not skip them on the depth PNG alone."""
    stem = os.path.splitext(os.path.basename(img_path))[0]
    if not os.path.exists(os.path.join(a.out, f"{stem}_depth.png")):
        return False
    if a.depth16 and not os.path.exists(
        os.path.join(a.out, f"{stem}_depth16.png")
    ):
        return False
    return not a.effect or os.path.exists(
        os.path.join(a.out, f"{stem}_effect.png")
    )


def solve_pairs(
    pairs: List[Tuple[str, str]],
    out_dir: str,
    cfg: DiffusionConfig = DiffusionConfig(),
    effect: Optional[int] = None,
    progress=None,
    io_workers: int = 4,
    prefetch: int = 2,
    keep_going: bool = False,
    png_level: Optional[int] = None,
    depth16: bool = False,
    stats_out: Optional[Dict[str, float]] = None,
    pipelines: Optional[Dict[Tuple[int, int], "DepthPipeline"]] = None,
) -> List[Optional[str]]:
    """Solve every pair; returns the written depth-map paths in input order.
    Pipelines are compiled once per distinct image shape (shape bucketing).
    A long-running service can pass its own ``pipelines`` dict to keep the
    per-shape programs (and their device state) alive across calls instead
    of re-acquiring them per batch.

    ``stats_out``, when given a dict, receives per-pair device latency in
    seconds keyed by image path: wall time from the pair's device work
    starting (pipeline build + image upload + solve dispatch) to u8-depth
    readback completion. The first pair of a shape charges that shape's
    program acquisition (compile or persistent-cache load); later pairs
    measure steady-state upload+solve+readback. Duplicate-stem losers
    (whose readback is skipped, last-wins) record no entry.

    ``depth16=True`` additionally writes ``{stem}_depth16.png`` — a 16-bit
    PNG at the solver's full precision (io.depth_to_u16), converted on
    device like the u8 map.

    ``keep_going=True`` turns per-pair host-IO failures (corrupt PNG,
    annotation/image shape mismatch, unwritable output) into a stderr
    warning and a ``None`` entry instead of aborting the whole run mid-way —
    the production-serving contract. Device/compile errors still raise: they
    would affect every pair.

    The host IO rides an async pipeline (the input-pipeline pattern — PNG/
    JPEG decode of a 1080p pair is host work comparable to the solve, so a
    sequential loop leaves the device idle much of the time): ``io_workers``
    threads decode up to ``prefetch``+1 pairs ahead, device readback of a
    solved pair is deferred until the NEXT solve is dispatched (JAX dispatch
    is async, so the device computes pair i+1 while the host converts pair
    i), and PNG encodes run on the same thread pool. ``prefetch=0,
    io_workers=1`` degrades to the strictly sequential order of operations.
    Outputs are bit-identical either way — the pipeline only reorders host
    work, never device math (tests/test_serve_and_incremental.py).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from .pipeline import DepthPipeline

    os.makedirs(out_dir, exist_ok=True)
    pipes: Dict[Tuple[int, int], DepthPipeline] = (
        pipelines if pipelines is not None else {}
    )
    n = len(pairs)
    written: List[Optional[str]] = [None] * n
    io_workers = max(int(io_workers), 1)
    prefetch = max(int(prefetch), 0)
    # Output paths are keyed by stem; with threaded writes two pairs sharing
    # a stem could write the same file CONCURRENTLY (torn PNG). Preserve the
    # sequential loop's last-wins semantics: only the final occurrence of a
    # stem encodes; earlier duplicates just report the shared path.
    stems = [os.path.splitext(os.path.basename(p))[0] for p, _ in pairs]
    last_for_stem = {s: i for i, s in enumerate(stems)}

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        loads: deque = deque()  # (index, decode future)
        # (index, img_path, stem, depth_u8, d16, art, dispatch perf_counter)
        inflight: deque = deque()
        writes: deque = deque()  # (index, img_path, write future)
        # Duplicate-stem pairs don't encode (last-wins); their progress
        # callbacks fire only once the WINNING pair's PNG is on disk, so a
        # consumer that opens the reported path never sees a missing file.
        dup_waiters: Dict[int, List[Tuple[int, str]]] = {}
        failed: set = set()  # indices whose decode failed (keep_going only)
        next_load = 0

        def pump_loads():
            nonlocal next_load
            while next_load < n and len(loads) < prefetch + 1:
                img_path, ann_path = pairs[next_load]
                loads.append(
                    (next_load, pool.submit(_load_pair, img_path, ann_path, cfg))
                )
                next_load += 1

        def drain_solve():
            """Read back the oldest solved pair and hand it to a writer."""
            i, img_path, stem, depth_u8, d16, art, t_dispatch = inflight.popleft()
            if last_for_stem[stem] != i:
                if last_for_stem[stem] in failed:
                    # The stem's winning pair failed to decode (keep_going):
                    # this earlier duplicate's encode was going to be skipped
                    # in its favor — nothing will write the stem, so report
                    # nothing (re-running without the broken pair recovers).
                    print(
                        f"warning: {img_path}: skipped (duplicate of failed "
                        f"pair {pairs[last_for_stem[stem]][0]})",
                        file=sys.stderr,
                    )
                    return
                # A later pair writes this stem; skip the dead encode and
                # report the path the winner will write (last-wins). Progress
                # is deferred to the winner's write completion (drain order is
                # input order, so the winner always drains after this pair).
                written[i] = os.path.join(out_dir, f"{stem}_depth.png")
                dup_waiters.setdefault(last_for_stem[stem], []).append(
                    (i, img_path)
                )
                return
            # depth is converted to u8 ON DEVICE (pipe.depth_u8, bit-equal
            # to io.depth_to_u8): a 4x smaller readback than f32.
            depth_np = np.asarray(depth_u8)  # blocks until the device is done
            if stats_out is not None:
                stats_out[img_path] = time.perf_counter() - t_dispatch
            d16_np = np.asarray(d16) if d16 is not None else None
            art_np = np.asarray(art) if art is not None else None

            def write():
                if art_np is not None:
                    imwrite(
                        os.path.join(out_dir, f"{stem}_effect.png"), art_np,
                        png_level=png_level,
                    )
                if d16_np is not None:
                    imwrite(
                        os.path.join(out_dir, f"{stem}_depth16.png"), d16_np,
                        png_level=png_level,
                    )
                dp = os.path.join(out_dir, f"{stem}_depth.png")
                imwrite(dp, depth_np, png_level=png_level)
                return dp

            writes.append((i, img_path, pool.submit(write)))

        def drain_writes(block: bool, keep: int = 0):
            while len(writes) > keep and (block or writes[0][2].done()):
                i, img_path, fut = writes.popleft()
                try:
                    written[i] = fut.result()
                except Exception as e:
                    if not keep_going:
                        raise
                    print(f"warning: {img_path}: write failed: {e}",
                          file=sys.stderr)
                    written[i] = None
                    for j, _p in dup_waiters.pop(i, ()):
                        written[j] = None
                    continue
                if progress:
                    progress(img_path, written[i])
                    for _j, dup_path in dup_waiters.pop(i, ()):
                        progress(dup_path, written[i])

        pump_loads()
        while loads:
            i, fut = loads.popleft()
            try:
                rgb, mask, value = fut.result()
            except Exception as e:
                if not keep_going:
                    raise
                print(f"warning: {pairs[i][0]}: skipped: {e}", file=sys.stderr)
                failed.add(i)
                # Duplicates that already deferred to this (now failed)
                # winner were never encoded — nothing owns their stem.
                for j, _p in dup_waiters.pop(i, ()):
                    written[j] = None
                pump_loads()
                continue
            pump_loads()  # keep the decode window full while we dispatch
            h, w = rgb.shape[:2]
            t_dispatch = time.perf_counter()  # charges pipeline build +
            # prepare + solve + readback; ~pure solve+readback once the
            # shape's programs exist (see stats_out docstring)
            if (h, w) in pipes and hasattr(pipes, "move_to_end"):
                # A long-lived service passes an OrderedDict so it can evict
                # least-recently-USED shapes (not least-recently-compiled);
                # record the use (see _trim_pipelines).
                pipes.move_to_end((h, w))
            if (h, w) not in pipes:
                pipe = DepthPipeline(h, w, cfg)
                # Batch serving never kicks the background fused compile:
                # the staged path is bit-identical and the fused program
                # only saves per-solve dispatch overhead (which the async
                # pipeline hides), while an in-flight compile blocks process
                # exit for its full duration (pipeline._join_background_
                # compiles — XLA compiles cannot be cancelled). Seed the
                # cache with rtdd-warmup if one-dispatch solves matter.
                pipe.background_compile = False
                # Overlap the staged compile with this pair's gray-pyramid
                # compile + upload (the staged programs are needed
                # synchronously by the solve below either way).
                pipe.prewarm_async()
                pipes[(h, w)] = pipe
            pipe = pipes[(h, w)]
            rgb_d, gpyr = pipe.prepare_image(rgb)
            state = pipe.initial_state()
            mask_d, value_d = jnp.asarray(mask), jnp.asarray(value)
            stem = stems[i]
            if effect is None:
                depth, _ = pipe.solve(gpyr, mask_d, value_d, state)
                art = None
            else:
                depth, _, art = pipe.solve_and_effect(
                    effect, gpyr, rgb_d, mask_d, value_d, state
                )
            inflight.append((
                i, pairs[i][0], stem, pipe.depth_u8(depth),
                pipe.depth_u16(depth) if depth16 else None, art, t_dispatch,
            ))
            # Keep up to min(prefetch, 2) solves in flight beyond the one
            # just queued: their readback overlaps the device working on
            # this one. prefetch=0 drains immediately (strictly sequential).
            while len(inflight) > min(prefetch, 2):
                drain_solve()
            drain_writes(block=False)
            # Bound host memory: if PNG encode is the bottleneck, block on
            # the oldest writes instead of accumulating encoded frames.
            drain_writes(block=True, keep=2 * io_workers + 4)
        while inflight:
            drain_solve()
        drain_writes(block=True)
    return written


def _load_pair(img_path: str, ann_path: str, cfg: DiffusionConfig):
    rgb = imread_rgb(img_path)
    mask, value = load_annotation(ann_path, cfg)
    h, w = rgb.shape[:2]
    if mask.shape != (h, w):
        raise ValueError(f"{ann_path}: shape {mask.shape} != image {(h, w)}")
    return rgb, mask, value


def solve_pairs_multichip(
    pairs: List[Tuple[str, str]],
    out_dir: str,
    cfg: DiffusionConfig = DiffusionConfig(),
    effect: Optional[int] = None,
    batch: Optional[int] = None,
    mesh=None,
    progress=None,
    keep_going: bool = False,
    png_level: Optional[int] = None,
    depth16: bool = False,
    io_workers: int = 4,
    stats_out: Optional[Dict[str, float]] = None,
) -> List[str]:
    """Multi-chip batch serving: shape-buckets the pairs, then drives the
    data-parallel + spatially-sharded batched step (parallel/sharded.py)
    over the ('batch','dy','dx') mesh — one compiled dispatch solves a whole
    batch of images across every chip. The last batch of a bucket is padded
    (by repeating its final pair) so each image shape compiles exactly one
    program; pad outputs are dropped. Per-pair outputs are identical to the
    sequential path up to the sharded solver's fp rounding (CPU-mesh test:
    tests/test_serve_and_incremental.py).

    Host IO is fully async like the single-chip path: ``io_workers`` pool
    threads decode the NEXT batch while the device runs the current one,
    and PNG encodes (~150 ms each at 1080p) are submitted to the same pool
    instead of serializing on the dispatch thread — batch B+1's dispatch
    overlaps batch B's encodes, with the write backlog bounded so host
    memory stays ~two batches. Pixels are untouched by the pipelining
    (bit-identical outputs; only host scheduling changes).

    Duplicate stems keep the single-chip last-wins contract: only the final
    occurrence of a stem (in input order) encodes; earlier duplicates
    report the winner's path once it is on disk.

    Returns the written depth-map paths in global input order.
    ``keep_going=True`` drops pairs whose decode fails (stderr warning)
    instead of aborting the run; a batch re-packs with the survivors.
    ``stats_out`` matches the single-chip contract (see ``solve_pairs``),
    with each pair charged an equal share of its batch's dispatch-to-
    readback wall.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from .core.multigrid import initial_depth_state
    from .parallel.mesh import make_mesh
    from .parallel.sharded import batched_step

    os.makedirs(out_dir, exist_ok=True)
    if mesh is None:
        mesh = make_mesh()
    b_mesh = mesh.shape["batch"]
    if batch is None:
        batch = max(b_mesh, 1)
    batch = -(-max(batch, 1) // b_mesh) * b_mesh  # divisible by the mesh axis
    eff = fx.EFFECT_NONE if effect is None else effect
    io_workers = max(int(io_workers), 1)

    stems = [os.path.splitext(os.path.basename(p))[0] for p, _ in pairs]
    last_for_stem = {s: i for i, s in enumerate(stems)}

    # Shape-bucket by the image HEADER alone (io.image_size — no pixel
    # decode): host RAM is bounded at ~two decoded batches regardless of how
    # many thousand pairs are queued, mirroring the single-chip path's
    # prefetch window. Items carry their global input index for the
    # last-wins bookkeeping (a stem's winner may sit in another bucket).
    buckets: Dict[Tuple[int, int], List[Tuple[int, str, str]]] = {}
    failed: set = set()  # global indices whose decode failed (keep_going)
    for i, (img_path, ann_path) in enumerate(pairs):
        try:
            size = image_size(img_path)
        except Exception as e:
            if not keep_going:
                raise
            print(f"warning: {img_path}: skipped: {e}", file=sys.stderr)
            failed.add(i)
            continue
        buckets.setdefault(size, []).append((i, img_path, ann_path))

    results: Dict[int, str] = {}
    writes: deque = deque()  # (global index, img_path, write future)
    # Non-winning duplicates waiting on the winner's write: winner index ->
    # [(dup index, dup img_path)]. Their progress fires only once the
    # winner's PNG is on disk (same contract as the single-chip path).
    dup_waiters: Dict[int, List[Tuple[int, str]]] = {}

    def drain_writes(block: bool, keep: int = 0):
        while len(writes) > keep and (block or writes[0][2].done()):
            i, img_path, fut = writes.popleft()
            try:
                dp = fut.result()
            except Exception as e:
                if not keep_going:
                    raise
                print(f"warning: {img_path}: write failed: {e}",
                      file=sys.stderr)
                dup_waiters.pop(i, None)  # waiters report nothing
                continue
            results[i] = dp
            if progress:
                progress(img_path, dp)
            for j, dup_path in dup_waiters.pop(i, ()):
                results[j] = dp
                if progress:
                    progress(dup_path, dp)

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for (h, w), items in buckets.items():
            fn, _ = batched_step(mesh, h, w, cfg, effect=eff)
            state0 = initial_depth_state(h, w, cfg)
            # Invariant per bucket: broadcast the fresh multigrid state once,
            # not once per batch dispatch.
            state = tuple(
                jnp.broadcast_to(s, (batch,) + s.shape) for s in state0
            )
            starts = list(range(0, len(items), batch))

            def decode(chunk):
                # One future per pair (not pool.map: its iterator dies at the
                # first decode error, taking the rest of the batch with it).
                return [
                    (it, pool.submit(
                        lambda p: _load_pair(p[1], p[2], cfg), it
                    ))
                    for it in chunk
                ]

            def gather(futs):
                out = []
                for it, f in futs:
                    try:
                        out.append((it, f.result()))
                    except Exception as e:
                        if not keep_going:
                            raise
                        print(f"warning: {it[1]}: skipped: {e}",
                              file=sys.stderr)
                        failed.add(it[0])
                return out

            pending = decode(items[starts[0] : starts[0] + batch])
            for bi, lo in enumerate(starts):
                chunk = gather(pending)  # block for this batch's decodes
                if bi + 1 < len(starts):  # decode ahead (bounded: one batch)
                    lo2 = starts[bi + 1]
                    pending = decode(items[lo2 : lo2 + batch])
                if not chunk:  # every pair in the batch failed (keep_going)
                    continue
                n = len(chunk)
                fill = [chunk[-1]] * (batch - n)
                rgbs = np.stack([it[1][0][..., :3] for it in chunk + fill])
                masks = np.stack([it[1][1].astype(bool) for it in chunk + fill])
                values = np.stack([it[1][2] for it in chunk + fill])
                t_dispatch = time.perf_counter()
                depth, _, art = fn(
                    jnp.asarray(rgbs), jnp.asarray(masks), jnp.asarray(values), state
                )
                depth_np = np.asarray(depth)
                art_np = np.asarray(art) if effect is not None else None
                if stats_out is not None:
                    # Batched dispatch: each RECORDED pair carries an equal
                    # share of the batch's dispatch-to-readback wall.
                    # Duplicate-stem losers record NO entry (single-chip
                    # contract: no output of their own backs a latency), so
                    # the wall divides by the number of winners — recorded
                    # shares sum back to the batch's actual wall even in
                    # loser-heavy batches.
                    winners = [
                        img_path
                        for (i, img_path, _ann), _data in chunk
                        if last_for_stem[stems[i]] == i
                    ]
                    share = (time.perf_counter() - t_dispatch) / max(
                        len(winners), 1
                    )
                    for img_path in winners:
                        stats_out[img_path] = share
                for k, ((i, img_path, _ann), _data) in enumerate(chunk):
                    stem = stems[i]
                    win = last_for_stem[stem]
                    if win != i:
                        # A later pair owns this stem (last-wins): skip the
                        # dead encode. Report the winner's path — now if its
                        # write already landed (its bucket may have run
                        # first), otherwise when it does.
                        if win in failed:
                            print(
                                f"warning: {img_path}: skipped (duplicate "
                                f"of failed pair {pairs[win][0]})",
                                file=sys.stderr,
                            )
                        elif win in results:
                            results[i] = results[win]
                            if progress:
                                progress(img_path, results[win])
                        else:
                            dup_waiters.setdefault(win, []).append(
                                (i, img_path)
                            )
                        continue
                    d_np = depth_np[k]
                    a_np = art_np[k] if art_np is not None else None

                    def write(d_np=d_np, a_np=a_np, stem=stem):
                        if a_np is not None:
                            imwrite(
                                os.path.join(out_dir, f"{stem}_effect.png"),
                                a_np, png_level=png_level,
                            )
                        if depth16:
                            imwrite(
                                os.path.join(out_dir, f"{stem}_depth16.png"),
                                depth_to_u16(d_np), png_level=png_level,
                            )
                        dp = os.path.join(out_dir, f"{stem}_depth.png")
                        imwrite(dp, depth_to_u8(d_np), png_level=png_level)
                        return dp

                    writes.append((i, img_path, pool.submit(write)))
                drain_writes(block=False)
                # Bound host memory: if PNG encode is the bottleneck, block
                # on the oldest writes instead of accumulating batches.
                drain_writes(block=True, keep=2 * io_workers + 4)
        drain_writes(block=True)
    for win, waiters in dup_waiters.items():
        # The stem's winner never produced a file (its decode failed under
        # keep_going after the duplicate had already deferred to it).
        for _j, dup_path in waiters:
            print(
                f"warning: {dup_path}: skipped (duplicate of failed pair "
                f"{pairs[win][0]})",
                file=sys.stderr,
            )
    return [results[i] for i in sorted(results)]


def config_from_args(a, error=None) -> DiffusionConfig:
    """Resolve the CLI namespace into a DiffusionConfig.

    The shared solver surface (profiles, early exit, SOR tuning, defocus
    quality — identical semantics across every CLI) resolves in
    flags.resolve_solver_flags; serving layers only --iterations on top.
    Factored out of main() so tests can assert a flag set resolves to the
    intended config without running a solve.
    """
    from .flags import resolve_solver_flags

    def fail(msg: str):
        if error is not None:
            error(msg)  # argparse .error: prints usage + exits 2
        raise ValueError(msg)

    kw = resolve_solver_flags(a, fail)
    if a.iterations is not None:
        kw["max_iterations"] = max(int(a.iterations), 1)
    return DiffusionConfig(**kw)


def _trim_pipelines(pipelines, cap: int) -> List[Tuple[int, int]]:
    """Evict least-recently-used per-shape pipelines beyond ``cap`` (watch
    mode's resident-memory bound: each DepthPipeline pins a full set of
    compiled XLA executables on the device, so a service fed arbitrarily
    many distinct image shapes would otherwise grow without bound).
    ``pipelines`` is an OrderedDict maintained in least-recently-USED-first
    order (solve_pairs move_to_end's a shape on every use). Returns the
    evicted shape keys (for the log line). Evicted shapes recompile on next
    sight — or load from the persistent compile cache in seconds."""
    evicted = []
    while len(pipelines) > max(cap, 1):
        shape, _pipe = pipelines.popitem(last=False)
        evicted.append(shape)
    return evicted


def _watch(a, cfg, eff, t_run0) -> int:
    """--watch service loop: poll the pair directories, solve what's new.

    A pair is DUE when its (image mtime, annotation mtime) signature
    differs from the last signature it was solved at — so both brand-new
    pairs and edits to either file of an existing pair re-solve; the
    signature is captured BEFORE the solve, so a file updated mid-solve is
    simply due again on the next scan (no lost updates). Decode/write
    failures never kill the service: the pair retries on later scans (the
    common cause is a file still being copied in) and is recorded 'failed'
    after _WATCH_MAX_ATTEMPTS consecutive failures of the SAME signature —
    touching the file re-arms it. Per-shape pipelines persist across
    batches (solve_pairs' ``pipelines``), so steady-state latency is the
    warm path. Exits 0 on --idle-exit, Ctrl-C, or SIGTERM (the service-
    manager stop signal, handled like Ctrl-C so the final manifest is still
    written); 1 if any pair was in the given-up failed state at exit.
    --report rewrites the manifest after every batch and on exit, one entry
    per pair ever seen (latest status), so an external pipeline can consume
    it while the service runs.
    """
    import signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt  # exit through the Ctrl-C path

    try:
        # signal.signal works only on the main thread; embedded callers
        # (tests driving _watch from a worker thread) keep their process's
        # default SIGTERM handling.
        prev_term = signal.signal(signal.SIGTERM, _term)
    except ValueError:
        prev_term = None

    from collections import OrderedDict

    # Least-recently-used-first: solve_pairs records uses (move_to_end) and
    # _trim_pipelines bounds resident shapes at --max-shapes after each batch.
    pipelines: "OrderedDict[Tuple[int, int], object]" = OrderedDict()
    outputs: Dict[str, str] = {}
    stats: Dict[str, float] = {}
    # All bookkeeping is keyed by IMAGE PATH, not stem: two images sharing a
    # stem (a.jpg + a.png matching the same annotation) are distinct pairs
    # to the scanner — keying by stem would make their alternating
    # signatures re-solve each other forever.
    snapshot: Dict[str, Tuple[float, float]] = {}  # img -> settled signature
    # img -> (signature it failed at, consecutive failures at it). One entry
    # per image (not per signature): a file that keeps changing mtime while
    # broken must not leak an entry per signature it ever failed at.
    fails: Dict[str, Tuple[Tuple[float, float], int]] = {}
    given_up: set = set()  # imgs recorded 'failed' at their current sig
    pair_by_img: Dict[str, str] = {}  # img -> ann, first-seen order
    skipped_existing: set = set()
    last_work = time.monotonic()
    first_scan = True

    def write_report():
        if a.report:
            _write_report(a, cfg, list(pair_by_img.items()), outputs,
                          skipped_existing, t_run0, stats)

    def progress(src, dst):
        outputs[src] = dst
        print(f"{src} -> {dst}")

    print(f"watching {a.images} + {a.annotations} "
          f"(poll {a.poll_interval:g}s"
          + (f", idle-exit {a.idle_exit:g}s" if a.idle_exit else "")
          + ")", file=sys.stderr)
    try:
        while True:
            due: List[Tuple[str, str]] = []
            sigs: Dict[str, Tuple[float, float]] = {}
            for img, ann in discover_pairs(a.images, a.annotations):
                try:
                    sig = (os.path.getmtime(img), os.path.getmtime(ann))
                except OSError:
                    continue  # deleted between listdir and stat
                pair_by_img.setdefault(img, ann)
                if snapshot.get(img) == sig:
                    continue
                if first_scan and a.skip_existing and _outputs_done(a, img):
                    snapshot[img] = sig
                    skipped_existing.add(img)
                    continue
                sigs[img] = sig
                due.append((img, ann))
            first_scan = False
            if due:
                written = solve_pairs(
                    due, a.out, cfg, eff, progress=progress,
                    io_workers=a.io_workers, prefetch=a.prefetch,
                    keep_going=True,  # a service outlives one bad file
                    png_level=a.png_level, depth16=a.depth16,
                    stats_out=stats, pipelines=pipelines,
                )
                for (img, _ann), w in zip(due, written):
                    sig = sigs[img]
                    if w:
                        snapshot[img] = sig
                        given_up.discard(img)
                        fails.pop(img, None)
                    else:
                        prev_sig, prev_k = fails.get(img, (None, 0))
                        k = prev_k + 1 if prev_sig == sig else 1
                        fails[img] = (sig, k)
                        if k >= _WATCH_MAX_ATTEMPTS:
                            # Stop retrying this signature; a touch re-arms.
                            snapshot[img] = sig
                            given_up.add(img)
                            # The manifest reports the LATEST status: an
                            # output from an earlier signature must not keep
                            # this pair 'solved' (with a stale path and
                            # solve_s) while the service gives up on its
                            # current contents and exits 1.
                            outputs.pop(img, None)
                            stats.pop(img, None)
                            # And the DISK must agree with the manifest: a
                            # consumer globbing --out instead of reading the
                            # report must not find a plausible-looking
                            # output solved from the earlier signature.
                            stem = os.path.splitext(
                                os.path.basename(img)
                            )[0]
                            for suffix in ("_depth.png", "_depth16.png",
                                           "_effect.png"):
                                try:
                                    os.unlink(
                                        os.path.join(a.out, stem + suffix)
                                    )
                                except OSError:
                                    pass
                            print(f"watch: giving up on {img} after "
                                  f"{k} attempts (touch it to retry; stale "
                                  f"outputs removed)",
                                  file=sys.stderr)
                evicted = _trim_pipelines(pipelines, a.max_shapes)
                if evicted:
                    print(f"watch: evicted {len(evicted)} resident shape "
                          f"pipeline(s) over --max-shapes={a.max_shapes}: "
                          + ", ".join(f"{h}x{w}" for h, w in evicted),
                          file=sys.stderr)
                write_report()
                # Idle counts from the END of the batch: a first batch
                # longer than --idle-exit (compiles) must not read as idle.
                last_work = time.monotonic()
            if (a.idle_exit is not None
                    and time.monotonic() - last_work >= a.idle_exit):
                print(f"watch: idle for {a.idle_exit:g}s, exiting",
                      file=sys.stderr)
                break
            time.sleep(a.poll_interval)
    except KeyboardInterrupt:
        print("watch: interrupted, exiting", file=sys.stderr)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        write_report()
    return 1 if given_up else 0


_WATCH_MAX_ATTEMPTS = 3


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="rtdd-serve", description=__doc__)
    p.add_argument("--pairs", nargs="*", default=[],
                   help="image:annotation path pairs")
    p.add_argument("--images", help="directory of images")
    p.add_argument("--annotations", help="directory of annotations")
    p.add_argument("--out", required=True)
    p.add_argument("--effect", choices=list(_EFFECT_BY_KEY), default=None)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_interpret"],
                   help="auto: the coarse-level GPU kernel where it applies, "
                        "XLA elsewhere; xla; pallas: the kernel, an error "
                        "where the platform has none (ops/dispatch.py)")
    p.add_argument("--solver", default=None,
                   choices=["jacobi_chebyshev", "jacobi", "red_black"],
                   help="solver variant (default jacobi_chebyshev, the "
                        "reference algorithm; a --profile may change it)")
    p.add_argument("--iterations", type=int, default=None,
                   help="coarsest-level iteration budget (default 1000, the "
                        "reference schedule); a quality/latency knob")
    p.add_argument("--profile", choices=["faithful", "fast"], default=None,
                   help="named solver profile: 'faithful' = the reference "
                        "schedule (today's defaults); 'fast' = red_black + "
                        "RMS residual early exit at tolerance 1e-3 — the "
                        "framework's fastest-converging configuration "
                        "(CPU quality ledger, PERF.md). Explicit solver "
                        "flags override the profile's choices")
    p.add_argument("--multigrid", choices=["cascadic", "vcycle"],
                   default=None,
                   help="multigrid scheme (default cascadic, the reference "
                        "coarse-to-fine pass; vcycle adds polishing cycles)")
    p.add_argument("--early-exit", action="store_true",
                   help="stop a level once the residual drops below the "
                        "tolerance (every solver honors it; the reference "
                        "declares a tolerance and ignores it)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="residual tolerance; implies --early-exit (default "
                        "1e-5, the value the reference declares but never "
                        "uses)")
    p.add_argument("--residual-metric", choices=list(VALID_RESIDUAL_METRICS),
                   default=None,
                   help="early-exit residual functional (default rms; the "
                        "max-norm cannot fire at fine levels, PERF.md)")
    p.add_argument("--rb-rho", type=float, default=None,
                   help="spectral-radius estimate for the red-black "
                        "cyclic-Chebyshev omegas (default 0.9999)")
    p.add_argument("--rb-plain", action="store_true",
                   help="plain Gauss-Seidel red-black (disable the SOR "
                        "omegas)")
    p.add_argument("--defocus-quality", choices=["auto", "exact", "approx"],
                   default=None,
                   help="refocus window-half candidate set (default auto: "
                        "exact through ~1440p apertures — the reference "
                        "semantics where exactness is the contract — and "
                        "bounded-error approx at 4K+, loudly reported; "
                        "'approx' snaps blur windows larger than 16 px to "
                        "a stride grid; error ledger in PERF.md)")
    p.add_argument("--defocus-stride", type=int, default=None, metavar="N",
                   help="approx candidate stride (default 4; implies "
                        "--defocus-quality approx)")
    p.add_argument("--multichip", action="store_true",
                   help="batched serving over the full device mesh "
                        "(data parallel x 2-D spatial sharding)")
    p.add_argument("--batch", type=int, default=None,
                   help="images per multi-chip dispatch (rounded up to the "
                        "mesh batch axis; default = the mesh batch axis)")
    p.add_argument("--io-workers", type=int, default=4,
                   help="host threads for PNG decode/encode (both paths; "
                        "1 disables IO parallelism)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="pairs decoded ahead of the device (single-chip "
                        "path; 0 = strictly sequential)")
    p.add_argument("--keep-going", action="store_true",
                   help="skip pairs whose decode/write fails (stderr "
                        "warning; exit code 1 if any were skipped) instead "
                        "of aborting the whole run")
    p.add_argument("--depth16", action="store_true",
                   help="also write {stem}_depth16.png: a 16-bit PNG at the "
                        "solver's full precision (u16 = depth x 257; the "
                        "8-bit map quantizes away the converged sub-gray "
                        "signal)")
    p.add_argument("--png-level", type=int, default=None, metavar="0-9",
                   help="PNG zlib effort for outputs (codec default 6; "
                        "1 encodes several times faster at a modest size "
                        "cost — encode is host work on every pair)")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip pairs whose depth map already exists in --out "
                        "(cheap resume after a partial/--keep-going run; "
                        "with --watch, applies to the initial scan)")
    p.add_argument("--watch", action="store_true",
                   help="run as a long-lived service: poll --images/"
                        "--annotations and solve every new pair — or pair "
                        "whose image/annotation changed on disk — as it "
                        "appears; per-shape compiled pipelines stay "
                        "resident across batches. Exit with Ctrl-C or "
                        "--idle-exit")
    p.add_argument("--max-shapes", type=int, default=8, metavar="N",
                   help="--watch: resident per-shape pipeline bound — the "
                        "N most-recently-used image shapes keep their "
                        "compiled programs on the device; older shapes are "
                        "evicted after each batch and recompile (or load "
                        "from the persistent cache) when seen again "
                        "(default 8)")
    p.add_argument("--poll-interval", type=float, default=2.0, metavar="S",
                   help="--watch directory scan period in seconds "
                        "(default 2)")
    p.add_argument("--idle-exit", type=float, default=None, metavar="S",
                   help="--watch: exit 0 after S seconds with no new work "
                        "(default: run until Ctrl-C)")
    p.add_argument("--report", metavar="FILE",
                   help="write a JSON run manifest: per-pair status "
                        "(solved path / skipped_existing / failed), counts, "
                        "wall time and the run configuration — the "
                        "machine-readable record a pipeline around "
                        "rtdd-serve consumes")
    a = p.parse_args(argv)
    t_run0 = time.perf_counter()
    cfg = config_from_args(a, p.error)  # resolve/validate flags up front
    # Validate BEFORE the --watch branch: an invalid level there would only
    # surface as a per-write zlib error inside the writer pool — the watch
    # loop would retry and give up on every pair while the service "runs".
    if a.png_level is not None and not 0 <= a.png_level <= 9:
        p.error("--png-level must be in 0..9")

    if a.watch:
        if not (a.images and a.annotations):
            p.error("--watch requires --images and --annotations "
                    "(directories to poll)")
        if a.pairs:
            p.error("--watch polls directories; --pairs makes no sense")
        if a.multichip:
            p.error("--watch is single-chip (resident per-shape pipelines); "
                    "use batch --multichip runs for mesh serving")
        if a.poll_interval <= 0:
            p.error("--poll-interval must be > 0")
        if a.idle_exit is not None and a.idle_exit < 0:
            p.error("--idle-exit must be >= 0")
        if a.max_shapes < 1:
            p.error("--max-shapes must be >= 1")
        from .utils.cache import enable_compilation_cache

        enable_compilation_cache()
        eff = _EFFECT_BY_KEY.get(a.effect) if a.effect else None
        os.makedirs(a.out, exist_ok=True)
        return _watch(a, cfg, eff, t_run0)

    pairs: List[Tuple[str, str]] = []
    for pr in a.pairs:
        img, ann = pr.split(":", 1)
        pairs.append((img, ann))
    if a.images and a.annotations:
        pairs.extend(discover_pairs(a.images, a.annotations))
    if not pairs:
        print("no input pairs", file=sys.stderr)
        return 2
    all_pairs = list(pairs)
    skipped_existing: set = set()
    if a.skip_existing:
        done = [_outputs_done(a, pr[0]) for pr in pairs]
        skipped_existing = {pr[0] for pr, d in zip(pairs, done) if d}
        pairs = [pr for pr, d in zip(pairs, done) if not d]
        if skipped_existing:
            print(f"skipping {len(skipped_existing)} already-solved pair(s)",
                  file=sys.stderr)
        if not pairs:
            print("solved 0 of 0 pair(s)")
            if a.report:
                _write_report(a, cfg, all_pairs, {}, skipped_existing, t_run0)
            return 0

    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    eff = _EFFECT_BY_KEY.get(a.effect) if a.effect else None
    runner = solve_pairs_multichip if a.multichip else solve_pairs
    kwargs = (
        {"batch": a.batch, "io_workers": a.io_workers}
        if a.multichip
        else {"io_workers": a.io_workers, "prefetch": a.prefetch}
    )
    outputs: Dict[str, str] = {}
    stats: Dict[str, float] = {}

    def progress(src, dst):
        outputs[src] = dst
        print(f"{src} -> {dst}")

    try:
        written = runner(
            pairs, a.out, cfg, eff,
            progress=progress,
            keep_going=a.keep_going,
            png_level=a.png_level,
            depth16=a.depth16,
            stats_out=stats,
            **kwargs,
        )
    except BaseException:
        # A run aborted mid-way (decode/write/device error without
        # --keep-going, or Ctrl-C) still writes the manifest: pairs not yet
        # solved report status 'failed', honoring _write_report's contract.
        if a.report:
            _write_report(a, cfg, all_pairs, outputs, skipped_existing,
                          t_run0, stats)
        raise
    ok = [w for w in written if w]
    print(f"solved {len(ok)} of {len(pairs)} pair(s)")
    if a.report:
        _write_report(a, cfg, all_pairs, outputs, skipped_existing, t_run0,
                      stats)
    return 0 if len(ok) == len(pairs) else 1


def _write_report(a, cfg, all_pairs, outputs, skipped_existing, t_run0,
                  stats=None) -> None:
    """JSON run manifest (--report): one entry per INPUT pair in input
    order — status 'solved' (with the written depth path), 'skipped_existing'
    (resume found every requested output), or 'failed' (decode/write error
    under --keep-going, or aborted before this pair) — plus counts, wall
    time, throughput over the solved set, per-pair device latency
    ('solve_s': dispatch-to-readback wall; the first pair of a shape charges
    its program acquisition), and the knobs that shaped the run."""
    import json

    stats = stats or {}
    wall_s = time.perf_counter() - t_run0
    entries = []
    for img, ann in all_pairs:
        if img in skipped_existing:
            stem = os.path.splitext(os.path.basename(img))[0]
            entries.append({
                "image": img, "annotation": ann, "status": "skipped_existing",
                "depth": os.path.join(a.out, f"{stem}_depth.png"),
            })
        elif img in outputs:
            entries.append({
                "image": img, "annotation": ann, "status": "solved",
                "depth": outputs[img],
                "solve_s": (round(stats[img], 4) if img in stats else None),
            })
        else:
            entries.append({"image": img, "annotation": ann,
                            "status": "failed", "depth": None})
    n_solved = sum(e["status"] == "solved" for e in entries)
    report = {
        "out_dir": a.out,
        "pairs": entries,
        "counts": {
            "total": len(entries),
            "solved": n_solved,
            "skipped_existing": len(skipped_existing),
            "failed": len(entries) - n_solved - len(skipped_existing),
        },
        "wall_s": round(wall_s, 3),
        "images_per_s": round(n_solved / wall_s, 3) if wall_s > 0 else None,
        # RESOLVED solver knobs (profile already applied), not the raw argv:
        # the manifest must say what actually ran.
        "config": {
            "profile": a.profile, "backend": cfg.backend,
            "solver": cfg.solver, "iterations": cfg.max_iterations,
            "multigrid": cfg.multigrid, "early_exit": cfg.early_exit,
            "tolerance": cfg.tolerance,
            "residual_metric": cfg.residual_metric,
            "rb_chebyshev": cfg.rb_chebyshev, "rb_rho": cfg.rb_rho,
            "effect": a.effect, "multichip": a.multichip, "batch": a.batch,
            "depth16": a.depth16, "png_level": a.png_level,
        },
    }
    with open(a.report, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report written: {a.report}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
