"""Bounded differential soak in the routine suite: 56 fixed-seed random
configurations through the public aligners -- fixed, adaptive and
large-band ranges across matrices, gap costs, and mode flags (x-drop,
local-start, free-start-gaps, TRACE), plus long-read rounds
(LongBatchAligner / LongAdaptiveAligner, traced and untraced) and PSSM
rounds -- every batch checked against the scalar oracle.

The open-ended variant (run-until-killed, fresh seeds) lives in
scripts/soak_fuzz.py; this file pins a reproducible slice of it.
The reference's analogous coverage is the accuracy example's len x k
sweep (reference: examples/accuracy.rs:17-34).
"""

import os
import sys

import pytest

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "scripts"),
)

from soak_fuzz import one_round, one_round_long, one_round_profile  # noqa: E402


@pytest.mark.parametrize("seed", range(5000, 5040))
def test_soak_config(seed):
    assert one_round(seed, n_pairs=6)


@pytest.mark.parametrize("seed", range(6000, 6010))
def test_soak_long_segmented(seed):
    assert one_round_long(seed, n_pairs=2)


@pytest.mark.parametrize("seed", range(7000, 7006))
def test_soak_profile_big(seed):
    assert one_round_profile(seed, n_pairs=3)
