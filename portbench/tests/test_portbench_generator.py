"""The frozen generator: the same rows for the same seed, the port's
synth_arrays rows at gene_skew 0, and TSVs that a plain parse reads
back as written."""

import json
import os

import numpy as np
import pytest

from portbench import gen
from portbench.reference import airr

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARRAYS = ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")


def small(name, rows=3000):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        c = json.load(f)
    c["sets"]["cohort"]["rows"] = rows
    return c


def test_same_seed_same_sets():
    a = gen.make_sets(small("keck20"), 2**31 + 11)
    b = gen.make_sets(small("keck20"), 2**31 + 11)
    c = gen.make_sets(small("keck20"), 2**31 + 12)
    for k in a:
        for f in ARRAYS:
            np.testing.assert_array_equal(a[k][f], b[k][f])
    assert not np.array_equal(a["cohort"]["seqs"], c["cohort"]["seqs"])


def test_cohort_is_the_ports_synth_arrays():
    from compairr_tpu_torch.bench import _plant_near_dups, synth_arrays

    p = dict(small("keck20")["sets"]["cohort"], gene_skew=0.0,
             repertoires=120, v_genes=50, j_genes=13)
    mine = gen.cohort(p, 7)
    theirs = synth_arrays(3000, 120, 50, 13, 7)
    for f in ARRAYS:
        np.testing.assert_array_equal(mine[f], getattr(theirs, f))
    gen.plant_substitutions(mine, 0.01, 9, 9)
    _plant_near_dups(theirs, theirs, 0.01, seed=9)
    for f in ARRAYS:
        np.testing.assert_array_equal(mine[f], getattr(theirs, f))


def test_skewed_genes_follow_zipf():
    s = gen.make_sets(small("keck20", 40000), 5)["cohort"]
    v = np.bincount(s["v_no"], minlength=50)
    # Zipf(s=1) over 50: gene 0 takes 1 / H_50 = 22 % of the rows
    assert 0.20 < v[0] / v.sum() < 0.245
    assert 1.8 < v[0] / v[1] < 2.2 and 1.35 < v[1] / v[2] < 1.65


def test_tsv_round_trip(tmp_path):
    c = small("keck20")
    sets = gen.make_sets(c, 2**31 + 99)
    for k, s in sets.items():
        path = str(tmp_path / f"{k}.tsv")
        gen.write_tsv(s, c["sets"][k]["columns"], path)
        got = airr.read(path)
        n = len(s["lengths"])
        np.testing.assert_array_equal(got["lengths"], s["lengths"])
        np.testing.assert_array_equal(got["counts"], s["counts"])
        w = got["seqs"].shape[1]
        assert w == s["lengths"].max()
        inside = np.arange(w)[None, :] < s["lengths"][:, None]
        np.testing.assert_array_equal(got["seqs"][inside],
                                      s["seqs"][:, :w][inside])
        assert [x.decode() for x in got["rep"]] == [
            s["rep_names"][r] for r in s["rep_no"]]
        assert [x.decode() for x in got["v"]] == [
            s["v_names"][r] for r in s["v_no"]]
        assert [x.decode() for x in got["j"]] == [
            s["j_names"][r] for r in s["j_no"]]
        assert got["seq_ids"] is None
        assert len(got["lengths"]) == n

