"""The controls come out not correct at a size a test run holds: the
reference in float32 on a self-comparison whose cells pass 2^24 (the
keck20 shape, 2 repertoires of 10,000 rows), and the reference without
indel matches (-d 1 -i) or at -d 1 in place of -d 2."""

import importlib

import pytest

from pb_small import small_root

from portbench import control


@pytest.mark.parametrize("workload", ["keck20.m-d1i", "keck20d2.m-d2-dense"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_controls(tmp_path, workload, seed):
    root = small_root(tmp_path, rows=20000, repertoires=2)
    k = control.readings(root, workload, seed)
    ref = importlib.import_module("portbench.reference."
                                  + control.cell(root, workload)["traffic"]
                                  ["reference"])
    assert all(k[name] > 0 for name in ref.CONTROLS)
