"""The igh10 cell's pieces on the CPU: the reference's pair search on
rows of 30 to 40 residues (where _piece_key's 5-bit shifts wrap the
uint64) against a brute-force all-pairs check, the cell's controls not
correct at a small size whose cells pass 2^24, its two metrics on
hand-built records and on a traced CPU run, and the cell run from its
files."""

import io
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from pb_small import small_root

from portbench import control, run
from portbench.reference import overlap_d1

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "igh10.m-d1i"
CARD = "NVIDIA H100 80GB HBM3"
NS = 10**9


def _near(a, b, indels):
    if len(a) == len(b):
        return sum(x != y for x, y in zip(a, b)) <= 1
    if not indels or abs(len(a) - len(b)) != 1:
        return False
    s, t = (a, b) if len(a) < len(b) else (b, a)
    return any(t[:p] + t[p + 1:] == s for p in range(len(t)))


def _long_rows(seed, n):
    """n rows of 30 to 40 residues over 4 gene pairs, most built as one
    edit of an earlier row, and rows built to collide in the wrapped
    piece keys: a copy of a row with residue 0 changed (a match), then
    with residue L // 2 changed too (two apart from the row, but each
    change is the first residue of its half, shifted out of that half's
    key, so both keys equal the row's)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        if rows and rng.random() < 0.6:
            vj, s = rows[int(rng.integers(len(rows)))]
            s = list(s)
            kind = int(rng.integers(3))
            p = int(rng.integers(len(s)))
            if kind == 1 and len(s) > 30:
                del s[p]
            elif kind == 2 and len(s) < 40:
                s.insert(p, int(rng.integers(20)))
            else:
                s[p] = (s[p] + int(rng.integers(1, 20))) % 20
        else:
            vj = int(rng.integers(4))
            s = [int(x) for x in rng.integers(0, 20, rng.integers(30, 41))]
        rows.append((vj, tuple(s)))
    for _ in range(n // 10):
        vj, s = rows[int(rng.integers(len(rows)))]
        t = list(s)
        t[0] = (t[0] + 1) % 20
        rows.append((vj, tuple(t)))  # one apart: a match
        t[len(t) // 2] = (t[len(t) // 2] + 1) % 20
        rows.append((vj, tuple(t)))  # two apart: a collision, no match
    return rows


def _as_set(rows):
    width = max(len(s) for _, s in rows)
    seqs = np.full((len(rows), width), 255, dtype=np.uint8)
    for i, (_, s) in enumerate(rows):
        seqs[i, : len(s)] = s
    return {"seqs": seqs,
            "lengths": np.array([len(s) for _, s in rows], dtype=np.int64),
            "vj": np.array([vj for vj, _ in rows], dtype=np.int64)}


@pytest.mark.parametrize("indels", [True, False])
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_match_pairs_on_long_rows_against_all_pairs(seed, indels):
    A = _long_rows(seed, 240)
    B = _long_rows(seed + 1, 200) + A[:40]
    for a_rows, b_rows in ((A, A), (A, B)):
        ia, ib = overlap_d1.match_pairs(_as_set(a_rows), _as_set(b_rows),
                                        indels)
        got = set(zip(ia.tolist(), ib.tolist()))
        want = {(i, j) for i, (va, sa) in enumerate(a_rows)
                for j, (vb, sb) in enumerate(b_rows)
                if va == vb and _near(sa, sb, indels)}
        assert got == want
        # more than the diagonal of a self-comparison
        assert len(want) > (len(a_rows) if a_rows is b_rows else 0)
    # the last row collides with its source row in both half keys, and
    # is no match of it
    src = next(i for i, r in enumerate(A[:240])
               if r[0] == A[-1][0] and len(r[1]) == len(A[-1][1])
               and sum(x != y for x, y in zip(r[1], A[-1][1])) == 2)
    s = _as_set([A[src], A[-1]])
    L = len(A[-1][1])
    for lo, hi in ((0, L // 2), (L // 2, L)):
        k = overlap_d1._piece_key(s["seqs"], s["vj"], lo, hi)
        assert k[0] == k[1]
    ia, ib = overlap_d1.match_pairs(s, s, indels)
    assert (0, 1) not in set(zip(ia.tolist(), ib.tolist()))


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_igh10_controls(tmp_path, seed):
    """2 donors of 10,000 rows: each diagonal cell sums about 10,000
    products of counts up to 99 (past 2^24, so float32 rounds it), and
    1 % of rows are planted one-indel copies."""
    root = small_root(tmp_path, rows=20000, repertoires=2)
    k = control.readings(root, CELL, seed)
    assert k["float32"] > 0 and k["no_indels"] > 0


def _span(name, sid, job, parent, t0, t1):
    return SimpleNamespace(name=name, id=sid, job=job, parent=parent,
                           thread=1, t0=int(t0 * NS), t1=int(t1 * NS),
                           counts={})


def test_tile_s_on_hand_built_spans():
    spans, sid = [], 0
    for t in (5.0, 10.0, 20.0):  # the first is the warm-up
        sid += 1
        job = sid
        spans.append(_span("job", job, job, None, t, t + 2))
        for name, a, b in (("engine.worklist", 0.5, 0.7),
                           ("engine.count", 0.7, 0.9),
                           ("engine.extract", 0.9, 1.2),
                           ("kernels.extract", 0.95, 1.0)):
            sid += 1
            spans.append(_span(name, sid, job, job, t + a, t + b))
    rec = {"window": (10.0, 30.0),
           "jobs": [{"start": t, "wall": 2.0, "ok": True}
                    for t in (10.0, 20.0)]}
    read = run.reader(ROOT, "tile_s")
    assert read(rec, spans) == pytest.approx(0.5)
    rec["jobs"].append({"start": 25.0, "wall": 2.0, "ok": True})
    assert read(rec, spans) is None


def test_tile_s_reads_nothing_without_the_record(monkeypatch):
    monkeypatch.setitem(sys.modules, "compairr_tpu_torch.utils.trace", None)
    rec = {"window": (0.0, 1.0), "jobs": [{}]}
    assert run.reader(ROOT, "tile_s")(rec) is None


def test_tile_roofline_reads_the_tile_kernels_alone():
    exp = {"input_residues": [335], "input_rows": [0], "rows": [],
           "cols": [], "pair_residues": 0}
    name = ("void (anonymous namespace)::tile_match_kernel<2, 5, true, "
            "false, false>(Args)")
    rec = {"window": (0.0, 1.0), "jobs": [{}, {}], "card": CARD,
           "expected": exp,
           "device_events": [("kernel", name, 0.1, 0.3),
                             ("kernel", "other_kernel", 0.3, 0.9),
                             ("gpu_memcpy", "Memcpy HtoD", 0.2, 0.5),
                             ("kernel", name, 0.9, 1.1)]}
    read = run.reader(ROOT, "tile_roofline")
    # 335 bytes a job = 1e-10 s; two jobs over 0.2 + 0.1 s of tile kernels
    assert read(rec) == pytest.approx(100 * 2e-10 / 0.3)
    assert read(dict(rec, device_events=rec["device_events"][1:3])) is None


def test_igh10_cell_from_its_files(tmp_path, monkeypatch):
    """The cell at 3,000 rows on the CPU: untraced with its end-to-end
    metrics, and traced with tile_s (tile_roofline needs the card's
    kernels, so the traced run lists tile_s alone)."""
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    from compairr_tpu_torch.utils import trace

    root = small_root(tmp_path)
    assert run.cell(root, CELL)["config"]["sets"]["cohort"]["v_genes"] == 56
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute(CELL, 2**31 + 5, 0.3, False, root=root,
                     require_card=False, build=False, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"job_s", "job_s_p95", "setup_s"}

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["per_layer"] = [e for e in m["per_layer"] if e["name"] == "tile_s"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    trace.reset()
    out, err = io.StringIO(), io.StringIO()
    try:
        rc = run.execute(CELL, 2**31 + 5, 0.3, True, root=root,
                         require_card=False, build=False, out=out, err=err)
    finally:
        monkeypatch.delenv("COMPAIRR_TIMING", raising=False)
        trace.reset()
        trace.refresh()
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["tile_s"]["value"] > 0
