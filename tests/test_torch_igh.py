"""An IGH-shaped cohort through the port's CLI on the tile route, on the
CPU (COMPAIRR_DEVICE=cpu): the generator parameters of
portbench/configs/igh10.json cut to 20,000 rows and 4 repertoires, with
a family of rows past 32 residues planted, so that lpad passes 32 and
every row takes two plane chunks. Held cell for cell to the plain
reference (portbench/reference/overlap_d1.py); the route's traced spans
carry the row-width counts."""

import json
import os

import pytest

from portbench import check, gen
from portbench.reference import overlap_d1

from compairr_tpu_torch import cli
from compairr_tpu_torch.ops import engine
from compairr_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 17
LONG = 38  # the planted family's length: past one 32-residue chunk


def _plant_long_family(s: dict) -> None:
    """Rows 0..4 become one V/J family past 32 residues: a row of LONG
    residues, a copy with one substitution in the second chunk, a copy
    with one residue of the second chunk deleted, a copy with one
    residue inserted there (so one-substitution, one-deletion and
    one-insertion pairs all meet the second chunk), and a copy with two
    substitutions there (equal to the row in the first chunk, and no
    match of it)."""
    s["seqs"] = gen._widened(s["seqs"], LONG + 2)
    base = [(7 * i + 3) % gen.ALPHA for i in range(LONG)]
    sub = list(base)
    sub[35] = (sub[35] + 1) % gen.ALPHA
    two = list(base)
    two[33], two[36] = (two[33] + 1) % gen.ALPHA, (two[36] + 1) % gen.ALPHA
    rows = [base, sub, base[:34] + base[35:],
            base[:33] + [5] + base[33:], two]
    for r, row in enumerate(rows):
        s["seqs"][r] = gen.PAD
        s["seqs"][r, : len(row)] = row
        s["lengths"][r] = len(row)
        s["v_no"][r], s["j_no"][r] = s["v_no"][0], s["j_no"][0]


@pytest.fixture(scope="module")
def igh_tsv(tmp_path_factory):
    with open(os.path.join(REPO, "portbench", "configs", "igh10.json")) as f:
        cfg = json.load(f)
    cfg["sets"]["cohort"].update(rows=20000, repertoires=4)
    s = gen.make_sets(cfg, SEED)["cohort"]
    _plant_long_family(s)
    path = str(tmp_path_factory.mktemp("igh") / "igh.tsv")
    gen.write_tsv(s, cfg["sets"]["cohort"]["columns"], path)
    return path


@pytest.mark.parametrize("argv", [["-m", "-d", "1", "-i"],
                                  ["-m", "-d", "1"]],
                         ids=["d1_indels", "d1"])
def test_igh_cut_on_the_tile_route(igh_tsv, tmp_path, monkeypatch, argv):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")  # -d 1 on the tiles too
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    trace.reset()
    try:
        out = tmp_path / "out.tsv"
        assert cli.main(argv + [igh_tsv, "-o", str(out)]) == 0
        assert engine.LAST_ROUTE == "tiles"
        spans = trace.spans()
    finally:
        trace.reset()
        monkeypatch.delenv("COMPAIRR_TIMING")
        trace.refresh()

    want = check.expected_cells(overlap_d1.solve_cli(argv, [igh_tsv]))
    assert len(want) == 5 and len(want[0]) == 5
    assert check.cells_off(out.read_text(), want) == 0

    width_spans = [s for s in spans
                   if s.name in ("engine.count", "kernels.extract")]
    assert {s.name for s in width_spans} == {"engine.count",
                                             "kernels.extract"}
    for s in width_spans:
        assert s.counts["chunks"] == 2, s.name
        assert 32 < s.counts["lpad"] <= 40, s.name
        # the planted family, and any drawn row past 32
        assert s.counts["rows_long"] >= 5, s.name
        assert s.counts["plane_bytes"] == 0, s.name  # no planes on the CPU
