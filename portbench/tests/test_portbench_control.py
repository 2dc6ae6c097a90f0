"""The controls come out not correct at a size a test run holds: the
reference in float32 on a self-comparison whose cells pass 2^24 (the
keck20 shape, 2 repertoires of 10,000 rows), and the reference without
indel matches."""

import pytest

from pb_small import small_root

from portbench import control


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_controls(tmp_path, seed):
    root = small_root(tmp_path, rows=20000, repertoires=2)
    k = control.readings(root, "keck20.m-d1i", seed)
    assert k["float32"] > 0 and k["no_indels"] > 0
