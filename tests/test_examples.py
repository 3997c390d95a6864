"""Smoke tests: the examples/ scripts must run end-to-end on CPU.

Each example exposes main(argv) precisely so these tests can drive it with
tiny inputs and a reduced sweep budget — the goal is 'the documented user
code paths execute', not convergence (covered by the oracle/golden suites).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from realtimedepthdiffusion.io import imwrite

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(_EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def tiny_pair(tmp_path, rng):
    img = os.path.join(tmp_path, "tiny.png")
    ann = os.path.join(tmp_path, "tiny_ann.png")
    imwrite(img, rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    a = np.full((96, 128), 32, np.uint8)  # sentinel = unannotated
    a[10:20, 10:30] = 0
    a[70:80, 90:120] = 254
    imwrite(ann, a)
    return img, ann


def test_example_01_depth_and_effects(tiny_pair, tmp_path):
    img, ann = tiny_pair
    out = os.path.join(tmp_path, "out")
    depth = _load("01_depth_and_effects").main(
        ["--image", img, "--annotation", ann, "--out", out, "--iterations", "40"]
    )
    assert depth.shape == (96, 128)
    for f in ("DepthMap.png", "Effect_refocus.png", "Effect_desaturation.png",
              "Effect_haze.png"):
        assert os.path.exists(os.path.join(out, f))


def test_example_02_warm_edits(tiny_pair):
    img, _ = tiny_pair
    depth = _load("02_warm_edits").main(
        ["--image", img, "--iterations", "40", "--incremental", "8"]
    )
    assert depth.shape == (96, 128)
    assert float(np.min(depth)) >= 0.0 and float(np.max(depth)) <= 255.0


def test_example_03_batch_serving(tiny_pair, tmp_path):
    img, ann = tiny_pair
    imgs, anns = os.path.join(tmp_path, "imgs"), os.path.join(tmp_path, "anns")
    os.makedirs(imgs), os.makedirs(anns)
    os.rename(img, os.path.join(imgs, "a.png"))
    os.rename(ann, os.path.join(anns, "a.png"))
    out = os.path.join(tmp_path, "depths")
    written = _load("03_batch_serving").main(
        ["--images", imgs, "--annotations", anns, "--out", out, "--iterations", "40"]
    )
    assert len(written) == 1 and os.path.exists(written[0])


def test_example_04_multichip():
    depth = _load("04_multichip").main(
        ["--rows", "64", "--cols", "96", "--iterations", "24"]
    )
    assert depth.shape[-2:] == (64, 96)
