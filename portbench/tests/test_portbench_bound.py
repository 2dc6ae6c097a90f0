"""match_roofline's bound, counted by hand on a tiny self-comparison."""

import pytest

from portbench import bound
from portbench.reference import overlap_d1

CARD = "NVIDIA H100 80GB HBM3"


def test_bound_by_hand(tmp_path):
    # ACDEF ~ ACDEG (one substitution), ACDEFG loses G -> ACDEF and
    # loses F -> ACDEG: with the diagonal, 3 + 6 ordered pairs
    p = tmp_path / "a.tsv"
    p.write_text("repertoire_id\tduplicate_count\tv_call\tj_call\t"
                 "junction_aa\n"
                 "R1\t2\tV1\tJ1\tACDEF\nR1\t3\tV1\tJ1\tACDEG\n"
                 "R1\t4\tV1\tJ1\tACDEFG\n")
    exp = overlap_d1.solve_cli(["-m", "-d", "1", "-i"], [str(p)])
    assert exp["pairs"] == 9
    # shorter row's residues: 5 + 5 + 6 on the diagonal, 5 for each of 6
    assert exp["pair_residues"] == 46
    b = bound.match_bound(exp, CARD)
    # 16 residues + 12 bytes a row x 3 rows + one 8-byte cell
    assert b["bytes"] == 16 + 36 + 8
    assert b["ops"] == 92
    assert b["bytes_s"] == pytest.approx(60 / 3.35e12)
    assert b["ops_s"] == pytest.approx(92 / 1979e12)
    assert b["bound_by"] == "bytes" and b["bound_s"] == b["bytes_s"]


def test_unknown_card_raises():
    with pytest.raises(ValueError):
        bound.match_bound({"input_residues": [1], "input_rows": [1],
                           "rows": [], "cols": [], "pair_residues": 0},
                          "some other card")


def test_roofline_reader():
    from portbench.run import reader, ROOT

    exp = {"input_residues": [335], "input_rows": [0], "rows": [],
           "cols": [], "pair_residues": 0}
    rec = {"window": (0.0, 1.0), "jobs": [{}, {}], "card": CARD,
           "expected": exp,
           "device_events": [("kernel", "k", 0.1, 0.1 + 1e-9),
                             ("gpu_memcpy", "m", 0.2, 0.5),
                             ("kernel", "k", 0.9, 1.1)]}
    read = reader(ROOT, "match_roofline")
    # 335 bytes a job = 1e-10 s; two jobs over 1e-9 + 0.1 s of kernels
    assert read(rec) == pytest.approx(100 * 2e-10 / (0.1 + 1e-9))
    assert read(dict(rec, device_events=[])) is None
