"""Config contract tests: pyramid geometry + iteration schedule formulas
(reference: src/main.cpp:95,103,263)."""

from realtimedepthdiffusion.config import DiffusionConfig, SCRIBBLE_DEPTH_VALUES

CFG = DiffusionConfig()


def test_level_count_1080p():
    # min(1920,1080)//45 = 24 -> int(log2(24)) + 1 = 5
    assert CFG.num_levels(1080, 1920) == 5


def test_level_count_dataset_sizes():
    # Dog.jpg is 560x700: min 560 // 45 = 12 -> int(log2(12)) + 1 = 4
    assert CFG.num_levels(700, 560) == 4
    # Tiny image: quotient clamps at 1 -> single level
    assert CFG.num_levels(40, 40) == 1
    assert CFG.num_levels(89, 2000) == 1
    assert CFG.num_levels(90, 2000) == 2


def test_iteration_schedule():
    # 1000 / 2^((L-1)-level), truncated: coarse->fine 1000,500,250,125,62
    L = 5
    assert [CFG.level_iterations(L, l) for l in range(L - 1, -1, -1)] == [
        1000,
        500,
        250,
        125,
        62,
    ]


def test_level_sizes_floor():
    assert CFG.level_size(1080, 1920, 0) == (1080, 1920)
    assert CFG.level_size(1080, 1920, 4) == (67, 120)
    assert CFG.level_size(853, 1280, 3) == (106, 160)


def test_brush_and_defocus_constants():
    assert CFG.brush_radius(1080, 1920) == 21  # 2% of min dim
    assert CFG.defocus_kernel_size(1080, 1920) == 55  # 0.025 * diagonal


def test_scribble_depth_values():
    # keys '0'..'4' -> min((k-'0')*64, 254) (src/main.cpp:41-43)
    assert SCRIBBLE_DEPTH_VALUES == (0, 64, 128, 192, 254)


def test_config_validation_at_construction():
    """Every surface fails loudly at config construction on a typo'd
    residual metric; early_exit pairs with EVERY solver (round 5: all three
    honor the tolerance the reference ignores, src/main.cpp:264)."""
    import pytest

    from realtimedepthdiffusion.config import DiffusionConfig

    with pytest.raises(ValueError, match="residual_metric"):
        DiffusionConfig(residual_metric="rsm")
    # every solver accepts the early exit now
    DiffusionConfig(early_exit=True)  # default jacobi_chebyshev
    DiffusionConfig(solver="jacobi", early_exit=True)
    DiffusionConfig(solver="red_black", early_exit=True, residual_metric="max")


def test_defocus_quality_validation_at_construction():
    """The approx-defocus knobs validate at construction like every other
    config field: unknown quality, a stride that is really the exact kernel,
    and a zero exact band are rejected loudly."""
    import pytest

    from realtimedepthdiffusion.config import DiffusionConfig

    with pytest.raises(ValueError, match="pallas_defocus_quality"):
        DiffusionConfig(pallas_defocus_quality="fast")
    with pytest.raises(ValueError, match="stride"):
        DiffusionConfig(pallas_defocus_quality="approx", pallas_defocus_stride=1)
    with pytest.raises(ValueError, match="exact_upto"):
        DiffusionConfig(pallas_defocus_quality="approx", pallas_defocus_exact_upto=0)
    # Valid approx configs construct fine; the knobs are inert under 'exact'
    # (any values accepted — they are never read). The 'auto' default CAN
    # resolve to approx, so its knobs validate like approx's.
    DiffusionConfig(pallas_defocus_quality="approx")
    DiffusionConfig(pallas_defocus_quality="exact",
                    pallas_defocus_exact_upto=0, pallas_defocus_stride=1)
    with pytest.raises(ValueError, match="stride"):
        DiffusionConfig(pallas_defocus_quality="auto", pallas_defocus_stride=1)
