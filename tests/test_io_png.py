"""The numpy + zlib PNG codec (io/image.py), checked against Pillow, and the
library path's independence from Pillow and OpenCV."""

import os
import subprocess
import sys

import numpy as np
import pytest

from realtimedepthdiffusion.io import (
    image_size, imread_gray, imread_rgb, imwrite, load_annotation, png_read,
    png_write, save_annotation,
)

Image = pytest.importorskip("PIL.Image")


def _content(h=45, w=70, seed=0):
    """Gradients + a noisy block: rows exercise every PNG filter Pillow's
    adaptive encoder picks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices((h, w))
    rgb = np.stack([(yy * 5) % 256, (xx * 3) % 256, (yy + xx) % 256], -1)
    rgb = rgb.astype(np.uint8)
    rgb[10:30, 20:50] = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    return rgb


@pytest.mark.parametrize(
    "shape, dtype",
    [((37, 53), np.uint8), ((37, 53, 3), np.uint8), ((37, 53), np.uint16),
     ((1, 1), np.uint8)],
    ids=["gray8", "rgb8", "gray16", "1x1"],
)
def test_png_write_round_trip_and_pillow_reads_it(tmp_path, shape, dtype):
    rng = np.random.default_rng(3)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    p = str(tmp_path / "a.png")
    png_write(p, a)
    got = png_read(p)
    assert got.dtype == a.dtype and np.array_equal(got, a)
    assert np.array_equal(np.asarray(Image.open(p)).astype(dtype), a)
    assert image_size(p) == shape[:2]


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "1", "I;16"])
def test_png_read_matches_pillow(tmp_path, mode):
    """Files Pillow writes (every filter type, palette, 1-bit, alpha,
    16-bit) decode to what Pillow's own RGB and L conversions give."""
    rgb = _content()
    if mode == "I;16":
        img = Image.fromarray(rgb[..., 0].astype(np.uint16) * 251)
    else:
        img = Image.fromarray(rgb).convert(mode)
    p = str(tmp_path / "in.png")
    img.save(p)
    ref = Image.open(p)
    if mode != "I;16":
        assert np.array_equal(imread_rgb(p), np.asarray(ref.convert("RGB")))
    assert np.array_equal(imread_gray(p), np.asarray(ref.convert("L")))
    assert image_size(p) == rgb.shape[:2]


def test_png_write_level_and_validation(tmp_path):
    rgb = _content()
    fast, small = str(tmp_path / "l1.png"), str(tmp_path / "l9.png")
    imwrite(fast, rgb, png_level=1)
    imwrite(small, rgb, png_level=9)
    assert np.array_equal(imread_rgb(fast), imread_rgb(small))
    with pytest.raises(ValueError, match="png_write takes"):
        png_write(str(tmp_path / "bad.png"), np.zeros((4, 4, 2), np.uint8))


def test_annotation_round_trip_without_pillow(tmp_path, monkeypatch):
    """The annotation contract and the PNG exports need no Pillow; other
    formats fail with an error that names the package."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    mask = np.zeros((20, 30), bool)
    mask[5:9, 7:12] = True
    value = np.where(mask, 192, 0).astype(np.uint8)
    p = str(tmp_path / "ann.png")
    save_annotation(p, mask, value)
    m2, v2 = load_annotation(p)
    assert np.array_equal(m2, mask) and np.array_equal(v2, value)
    jpg = str(tmp_path / "x.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="Pillow"):
        imread_rgb(jpg)
    with pytest.raises(ImportError, match="Pillow"):
        imwrite(jpg, np.zeros((4, 4, 3), np.uint8))


def test_library_path_imports_neither_pillow_nor_opencv():
    """The package, the pipeline, the core, the live session and serving
    import neither PIL nor cv2."""
    code = (
        "import sys\n"
        "import realtimedepthdiffusion, realtimedepthdiffusion.pipeline\n"
        "import realtimedepthdiffusion.core.effects, realtimedepthdiffusion.core.multigrid\n"
        "import realtimedepthdiffusion.live.session, realtimedepthdiffusion.live.cli\n"
        "import realtimedepthdiffusion.serve, realtimedepthdiffusion.io\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
