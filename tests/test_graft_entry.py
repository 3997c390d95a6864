"""Driver-contract smoke tests for __graft_entry__ (small-mesh variants; the
driver itself runs entry() single-chip and dryrun_multichip(N))."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as ge  # noqa: E402


def test_entry_builds():
    fn, args = ge.entry()
    assert callable(fn)
    rgb, mask, value, state = args
    assert rgb.shape == (1080, 1920, 3)
    assert mask.shape == (1080, 1920)
    assert len(state) == 5  # 5 pyramid levels at 1080p


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
@pytest.mark.slow
def test_dryrun_multichip_4():
    ge.dryrun_multichip(4)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 virtual devices")
@pytest.mark.slow
def test_dryrun_multichip_2():
    # Slow set: the driver itself runs dryrun_multichip(8) (with the same
    # in-function route + early-exit assertions) every round, so the fast
    # set does not need a ~20 s duplicate of that gate.
    ge.dryrun_multichip(2)
