"""The device busy share of roreg_tpu_torch.profile_pair: the union of
kernel intervals, overlaps counted once."""

import pytest

pytest.importorskip("torch")

from roreg_tpu_torch.profile_pair import _union_us  # noqa: E402


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlap
    ([(5.0, 6.0), (0.0, 1.0)], 2.0),  # unsorted, disjoint
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 12.0)], 12.0),  # nested, then extending
])
def test_union_counts_overlaps_once(intervals, total):
    assert _union_us(intervals) == total
