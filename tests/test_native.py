"""Native C++ runtime tests: builds librtdd_runtime.so with g++ and checks
parity with the Python/oracle semantics."""

import threading

import numpy as np
import pytest

from realtimedepthdiffusion.config import DiffusionConfig
from realtimedepthdiffusion.core.solver import chebyshev_omegas
from realtimedepthdiffusion.native.runtime import Arena, EventQueue, NativeRuntime
from realtimedepthdiffusion.oracle import numpy_ref as oracle

CFG = DiffusionConfig()


@pytest.fixture(scope="module")
def rt():
    r = NativeRuntime()
    if not r.available:
        pytest.skip("native toolchain unavailable")
    return r


def test_native_builds(rt):
    assert rt.available


def test_plan_matches_config(rt):
    for rows, cols in [(1080, 1920), (700, 560), (853, 1280), (64, 64)]:
        plan = rt.plan(rows, cols, CFG.pyramid_base_size, CFG.max_iterations)
        levels = CFG.num_levels(rows, cols)
        assert len(plan) == levels
        for l, (r, c, it) in enumerate(plan):
            assert (r, c) == CFG.level_size(rows, cols, l)
            assert it == CFG.level_iterations(levels, l)


def test_chebyshev_omegas_match(rt):
    got = rt.chebyshev_omegas(50, CFG.chebyshev_s, CFG.chebyshev_rho)
    want = chebyshev_omegas(50, CFG)
    assert np.array_equal(got, want)


def test_paint_matches_oracle(rt):
    h, w = 40, 60
    mask = np.zeros((h, w), np.uint8)
    value = np.zeros((h, w), np.uint8)
    rect = rt.paint(mask, value, 30, 20, 192, 9)
    om, ov = oracle.paint(np.zeros((h, w), bool), np.zeros((h, w), np.uint8), 30, 20, 192, 9)
    assert np.array_equal(mask.astype(bool), om)
    assert np.array_equal(value, ov)
    assert rect == (16, 26, 24, 34)
    # off-canvas stroke paints nothing
    m2 = np.zeros((h, w), np.uint8)
    v2 = np.zeros((h, w), np.uint8)
    assert rt.paint(m2, v2, -50, -50, 10, 4) is None
    assert m2.sum() == 0


def test_annotation_codec_roundtrip(rt):
    rng = np.random.default_rng(0)
    plane = rng.choice([0, 32, 64, 128, 192, 254], 1000).astype(np.uint8)
    mask, value = rt.annotation_decode(plane, 32)
    assert np.array_equal(mask, plane != 32)
    back = rt.annotation_encode(mask, value, 32)
    assert np.array_equal(back, plane)


def test_arena_alloc_alignment_and_reuse(rt):
    a = Arena(4096)
    assert a.native
    x = a.alloc_u8((8, 16))
    y = a.alloc_u8((4, 4), align=64)
    assert x.shape == (8, 16) and not x.any()
    assert y.ctypes.data % 64 == 0
    x[:] = 7
    assert not y.any()  # allocations don't alias
    assert a.used >= 8 * 16 + 4 * 4
    # capacity exhaustion falls back to the heap, still zeroed
    z = a.alloc_u8((100, 100))
    assert z.shape == (100, 100) and not z.any()
    a.close()


def test_session_buffers_are_arena_backed():
    from tests.conftest import synthetic_pair
    from realtimedepthdiffusion.live.session import DepthSession

    rgb, _, _ = synthetic_pair(32, 48, 5)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=5))
    if s.arena.native:
        assert s.arena.used >= 2 * 32 * 48 + 3 * 32 * 48
    s.paint(10, 10)
    img = s.edited_image()
    assert img is s._edited_buf  # composited in place, no per-frame alloc
    assert (img[10, 10] == s.scribble_color).all()


def test_event_queue_close_push_race():
    """close() vs push() from another thread must never fault (the GUI's
    mouse callback can fire during shutdown); post-close pushes return
    False."""
    for _ in range(20):
        q = EventQueue(capacity=64)
        stop = threading.Event()

        def pusher():
            while not stop.is_set():
                q.push(EventQueue.KIND_PAINT, 1, 2, 3)

        t = threading.Thread(target=pusher)
        t.start()
        q.close()
        stop.set()
        t.join()
        assert q.push(EventQueue.KIND_PAINT, 0, 0, 0) is False
        assert q.pop() is None


def test_event_queue_order_and_overflow():
    q = EventQueue(capacity=8)
    for i in range(5):
        assert q.push(EventQueue.KIND_PAINT, i, i * 2, 7)
    assert len(q) == 5
    for i in range(5):
        assert q.pop() == (EventQueue.KIND_PAINT, i, i * 2, 7)
    assert q.pop() is None
    # overflow drops (native) or evicts (fallback) without corruption
    for i in range(20):
        q.push(EventQueue.KIND_KEY, i, 0, 0)
    drained = []
    while (e := q.pop()) is not None:
        drained.append(e)
    assert 0 < len(drained) <= 8
    q.close()


def test_event_queue_threaded():
    q = EventQueue(capacity=1024)
    n_producers, per = 4, 200
    pushed_total = []

    def producer(pid):
        ok = 0
        for i in range(per):
            ok += q.push(EventQueue.KIND_PAINT, pid, i, 0)
        pushed_total.append(ok)

    threads = [threading.Thread(target=producer, args=(p,)) for p in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = []
    while (e := q.pop()) is not None:
        got.append(e)
    assert len(got) == sum(pushed_total)
    # per-producer FIFO order preserved
    for pid in range(n_producers):
        seq = [e[2] for e in got if e[1] == pid]
        assert seq == sorted(seq)
    q.close()
