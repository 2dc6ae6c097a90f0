"""The harness drives a whole run on the CPU (its look for a card
skipped) with the timed path broken underneath, and `correct` comes out
false: half of the pairs left out, one answer dropped where find_pairs
produces it, one value altered where the matrix is made. (A state left
unchanged and an exchange between cards left out are faults these cells
cannot have: no training state, one card.) The sound run is correct. A
job that leaves the card's kernels unlaunched is counted against the
run."""

import io
import json

import numpy as np
import pytest

from pb_small import small_root

from portbench import run


def half_pairs(res):
    n = len(res[0]) // 2
    return tuple(None if x is None else x[:n] for x in res)


def one_pair_dropped(res):
    i1, i2, d = res
    k = int(np.flatnonzero(i1 != i2)[0])
    keep = np.arange(len(i1)) != k
    return i1[keep], i2[keep], None if d is None else d[keep]


def broken_find_pairs(monkeypatch, fault):
    from compairr_tpu_torch.ops import engine

    orig = engine.find_pairs

    def find_pairs(*a, **kw):
        return fault(orig(*a, **kw))

    monkeypatch.setattr(engine, "find_pairs", find_pairs)


def value_altered(monkeypatch):
    from compairr_tpu_torch.core import score

    orig = score.matrix_values

    def matrix_values(*a, **kw):
        v = orig(*a, **kw).copy()
        v[0, 0] += 1
        return v

    monkeypatch.setattr(score, "matrix_values", matrix_values)


FAULTS = {
    None: lambda mp: None,
    "half_pairs": lambda mp: broken_find_pairs(mp, half_pairs),
    "one_pair_dropped": lambda mp: broken_find_pairs(mp, one_pair_dropped),
    "value_altered": value_altered,
}


@pytest.mark.parametrize("workload", ["keck20.m-d1i"])
@pytest.mark.parametrize("fault", list(FAULTS), ids=str)
def test_fault_is_not_correct(tmp_path, monkeypatch, workload, fault):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    root = small_root(tmp_path)
    FAULTS[fault](monkeypatch)
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute(workload, 2**31 + 77, 0.2, False, root=root,
                     require_card=False, build=False, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is (fault is None)
    assert (res["checks"]["cells_off"]["value"] == 0) is (fault is None)
    assert err.getvalue().splitlines()[-2].startswith("check cells_off")


def test_jobs_off_card_counted():
    want = ["count_tiles", "extract_tiles"]
    jobs = [{"count_tiles": 1, "extract_tiles": 3},
            {"count_tiles": 0, "extract_tiles": 0},
            {"count_tiles": 2, "extract_tiles": 0},
            {}]
    assert run.jobs_off_card(jobs, want) == 3
    assert run.jobs_off_card(jobs[:1], want) == 0
