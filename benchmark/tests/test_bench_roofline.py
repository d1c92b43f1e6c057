"""The roofline counts on a hand-sized window: 2 input reads of 150 and
120 bases, one output record of 150 bases."""

import pytest

from harness import roofline as rl


def test_vote_counts():
    nbytes, ops = rl.vote_work(150 + 120, 150)
    assert nbytes == 3 * 270 + 2 * 150 == 1110
    assert ops == 2700


def test_upload_counts_per_route():
    assert rl.upload_work(270, {"upload_score_kernel"}) == (1215, 16 * 270)
    assert rl.upload_work(270, {"upload_unpack_kernel", "score_map_kernel"}) == (1215, 20 * 270)


def test_bound_and_share():
    t, which = rl.bound_s(3.35e12, 0)
    assert t == pytest.approx(1.0) and which == "bytes"
    t, which = rl.bound_s(0, 16.7e12 * 2)
    assert t == pytest.approx(2.0) and which == "int32"
    assert rl.share_pct(3.35e9, 0, 4e-3) == pytest.approx(25.0)
    assert rl.share_pct(3.35e9, 0, 0.0) is None
