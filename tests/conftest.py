"""Test harness configuration.

Tests run on the JAX CPU backend with 8 virtual devices standing in for a
multi-device mesh (SURVEY.md §4): deterministic, fast, and independent of
any accelerator. The platform is forced here, before any test module
initializes a backend, unless the caller set JAX_PLATFORMS itself (the
``gpu``-marked tests run on the card that way: see chip_smoke.py).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# Pin the fast-start default OFF for the suite: routing stays deterministic
# (no solve switches program mid-test when a background compile lands) and
# no background monolith compile competes with the test CPUs. The
# dedicated fast-start tests opt back in with fast_start=True explicitly.
os.environ.setdefault("RTDD_FAST_START", "0")

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache (utils.cache: JAX_COMPILATION_CACHE_DIR, else
# the git-ignored <checkout>/.jax_cache). Recompiling the larger test
# programs dominates suite wall time; a warm cache cuts repeat runs.
from realtimedepthdiffusion.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DATASET = "/root/reference/dataset"


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream.
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def dataset_pair():
    """One (image, annotation) golden pair from the reference dataset, if
    mounted; otherwise a synthetic stand-in with the same contract."""
    img_path = os.path.join(REFERENCE_DATASET, "images", "Dog.jpg")
    ann_path = os.path.join(REFERENCE_DATASET, "annotations", "Dog.png")
    if os.path.exists(img_path) and os.path.exists(ann_path):
        from realtimedepthdiffusion.io import imread_rgb, load_annotation

        rgb = imread_rgb(img_path)
        mask, value = load_annotation(ann_path)
        return rgb, mask, value
    return synthetic_pair(420, 560)


def synthetic_pair(h: int, w: int, seed: int = 7):
    """Synthetic (rgb, mask, value) with the dataset's annotation contract:
    scribble blobs carrying depths from {0,64,128,192,254}."""
    r = np.random.default_rng(seed)
    rgb = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # Smooth the image a bit so edge weights vary.
    rgb = (rgb.astype(np.int32) + np.roll(rgb, 5, 0) + np.roll(rgb, 5, 1)) // 3
    rgb = rgb.astype(np.uint8)
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    depths = [0, 64, 128, 192, 254]
    for i, d in enumerate(depths):
        y = int((i + 1) * h / (len(depths) + 1))
        x = int((i + 1) * w / (len(depths) + 1))
        mask[y - 6 : y + 6, x - 8 : x + 8] = True
        value[y - 6 : y + 6, x - 8 : x + 8] = d
    return rgb, mask, value
