"""Distance 2: the generator's two-substitution step, which leaves the
other configurations' rows as they were; the -d 2 reference against a
brute-force count; the cell keck20d2.m-d2-dense through the port's
dense engine on the CPU, sound and with its path broken; and the dense
engine's two readers. (Its controls: test_portbench_control.py; its run
on the card: test_portbench_card.py.)"""

import hashlib
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from pb_small import small_root

from portbench import gen, run
from portbench.reference import overlap_d2

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "keck20d2.m-d2-dense"
ARRAYS = ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")
AA = "ACDEFGHIKLMNPQRSTVWY"

# sha256 of make_sets' arrays and TSV bytes of 5,000-row cuts, taken from
# the generator as it was before the two-substitution step came in
DIGESTS = {
    ("keck20", 7):
        "fa9df4a2b694c65ad48b264c1f28772a2215d9aec691f14e477c5fe7081b2a35",
    ("keck20", 2**31 + 17):
        "c73a8d61f86c48434a85c414b0f6f6721ed6f6442b350c9d2786bee48ad3ad3c",
    ("igh10", 7):
        "d10856642990473dbabde6596d326a289a655658d333c01f886c766d34509167",
    ("igh10", 2**31 + 17):
        "d667f4344663a4ec33e96d10d4b2783746e2dd4a0229504b22cafc9eb9b50b4f",
}


def config(name, rows):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        c = json.load(f)
    c["sets"]["cohort"]["rows"] = rows
    return c


@pytest.mark.parametrize("name,seed", list(DIGESTS), ids=str)
def test_other_configs_rows_unchanged(name, seed):
    c = config(name, 5000)
    s = gen.make_sets(c, seed)["cohort"]
    h = hashlib.sha256()
    for f in ARRAYS:
        a = s[f]
        h.update(f"{f} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    h.update(gen.tsv_bytes(s, c["sets"]["cohort"]["columns"]))
    assert h.hexdigest() == DIGESTS[name, seed]


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_two_substitution_pairs(seed):
    c = config("keck20d2", 20000)["sets"]["cohort"]
    s = gen.cohort(c, seed)
    gen.plant_indels(s, c["plant_indel"], [seed, 2])
    before = {k: s[k].copy() for k in ("seqs", "lengths", "v_no", "j_no")}
    gen.plant_substitutions2(s, c["plant_substitution2"], [seed, 3],
                             c["length_min"])
    rng = np.random.default_rng([seed, 3])
    n = len(s["lengths"])
    k = int(n * c["plant_substitution2"])
    src = rng.choice(n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    changed = np.flatnonzero(
        (s["seqs"] != before["seqs"]).any(axis=1)
        | (s["lengths"] != before["lengths"]))
    assert set(changed) <= set(dst)
    # each pair whose source row was not itself overwritten
    keep = ~np.isin(src, dst)
    assert keep.sum() > 0.9 * k
    a, b = src[keep], dst[keep]
    for f in ("lengths", "v_no", "j_no"):
        np.testing.assert_array_equal(s[f][a], s[f][b])
    np.testing.assert_array_equal(s["seqs"][a], before["seqs"][a])
    diff = s["seqs"][a] != s["seqs"][b]
    np.testing.assert_array_equal(diff.sum(axis=1), 2)
    inside = np.arange(diff.shape[1])[None, :] < np.minimum(
        s["lengths"][a], c["length_min"])[:, None]
    assert not (diff & ~inside).any()


def test_make_sets_plants_only_where_named():
    c = config("keck20d2", 5000)
    del c["sets"]["cohort"]["plant_substitution2"]
    base = gen.make_sets(c, 11)["cohort"]
    same = gen.make_sets(config("keck20", 5000), 11)["cohort"]
    planted = gen.make_sets(config("keck20d2", 5000), 11)["cohort"]
    for f in ARRAYS:
        np.testing.assert_array_equal(base[f], same[f])
    assert (planted["seqs"] != base["seqs"]).any(axis=1).sum() >= 45


def rows(seed, n, reps):
    """n rows over few genes, short lengths (1 to 8) and 4 letters, many
    built by up to three substitutions of others."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if out and rng.random() < 0.6:
            _, _, _, v, j, s = out[rng.integers(len(out))]
            s = list(s)
            for _ in range(int(rng.integers(0, 4))):
                s[rng.integers(len(s))] = AA[rng.integers(4)]
            s = "".join(s)
            if rng.random() < 0.2:
                v = f"V{rng.integers(2)}"
        else:
            s = "".join(AA[x] for x in rng.integers(0, 4, rng.integers(1, 9)))
            v, j = f"V{rng.integers(2)}", f"J{rng.integers(2)}"
        out.append((f"R{rng.integers(reps)}", f"q{i}",
                    int(rng.integers(1, 100)), v, j, s))
    return out


def write(path, rs):
    with open(path, "w") as f:
        f.write("repertoire_id\tsequence_id\tduplicate_count\tv_call\t"
                "j_call\tjunction_aa\n")
        for r in rs:
            f.write("\t".join(map(str, r)) + "\n")
    return str(path)


def brute(A, B, diffs=2):
    rows_ = sorted({r[0] for r in A})
    cols = sorted({r[0] for r in B})
    m = np.zeros((len(rows_), len(cols)))
    pairs = 0
    for a in A:
        for b in B:
            if (a[3], a[4], len(a[5])) == (b[3], b[4], len(b[5])) and sum(
                    x != y for x, y in zip(a[5], b[5])) <= diffs:
                m[rows_.index(a[0]), cols.index(b[0])] += a[2] * b[2]
                pairs += 1
    return rows_, cols, m, pairs


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("files", [1, 2])
def test_reference_against_brute_force(tmp_path, seed, files):
    A = rows(seed, 150, 3)
    B = rows(seed + 100, 130, 4) if files == 2 else A
    paths = [write(tmp_path / "a.tsv", A)]
    if files == 2:
        paths.append(write(tmp_path / "b.tsv", B))
    got = overlap_d2.solve_cli(["-m", "-d", "2"], paths)
    r, c, m, pairs = brute(A, B)
    assert (got["rows"], got["cols"]) == (r, c)
    np.testing.assert_array_equal(got["values"], m)
    assert got["pairs"] == pairs
    one = overlap_d2.solve_cli(["-m", "-d", "2"], paths, control="d1")
    np.testing.assert_array_equal(one["values"], brute(A, B, 1)[2])
    assert one["pairs"] < pairs


def test_reference_rejects_flags_it_does_not_implement(tmp_path):
    p = write(tmp_path / "a.tsv", rows(0, 5, 1))
    assert overlap_d2.solve_cli(["-m", "-d", "2"], [p])["pairs"]
    for flags in (["-m", "-d", "1"], ["-m", "-d", "2", "-i"],
                  ["-m", "-d", "2", "-t", "4"],
                  ["-m", "-d", "2", "-g"], ["-x", "-d", "2"],
                  ["-m", "-d", "2", "-s", "min"]):
        with pytest.raises(ValueError):
            overlap_d2.solve_cli(flags, [p])


def half_work(monkeypatch):
    from compairr_tpu_torch.ops import engine

    orig = engine.dense_span

    def dense_span(plan, a, b, work=None):
        return orig(plan, a, b, work[: len(work) // 2])

    monkeypatch.setattr(engine, "dense_span", dense_span)


def value_altered(monkeypatch):
    from compairr_tpu_torch.ops import engine

    orig = engine.dense_result

    def dense_result(*a, **kw):
        v = orig(*a, **kw)
        v[0, 0] += 1
        return v

    monkeypatch.setattr(engine, "dense_result", dense_result)


FAULTS = {None: lambda mp: None, "half_work": half_work,
          "value_altered": value_altered}


@pytest.mark.parametrize("fault", list(FAULTS), ids=str)
def test_cell_through_the_dense_engine(tmp_path, monkeypatch, fault):
    """The whole run on the CPU (its look for a card skipped): the port's
    COMPAIRR_ENGINE=dense -m -d 2 jobs equal the reference where sound,
    and come out not correct with half the worklist left out or one
    value altered where the matrix is made."""
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_ENGINE", "")  # the traffic sets it
    root = small_root(tmp_path, rows=6000, repertoires=4)
    FAULTS[fault](monkeypatch)
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute(CELL, 2**31 + 77, 0.2, False, root=root,
                     require_card=False, build=False, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    assert os.environ["COMPAIRR_ENGINE"] == "dense"
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"] is (fault is None)
    assert (res["checks"]["cells_off"]["value"] == 0) is (fault is None)
    assert err.getvalue().splitlines()[-2].startswith("check cells_off")


NS = 10**9


def _span(name, sid, job, parent, t0, t1):
    return SimpleNamespace(name=name, id=sid, job=job, parent=parent,
                           thread=1, t0=int(t0 * NS), t1=int(t1 * NS),
                           counts={})


def _dense_jobs(starts, laps=True):
    spans, sid = [], 0
    for t in starts:
        sid += 1
        job = sid
        spans.append(_span("job", job, job, None, t, t + 2))
        kids = [("io.parse", 0.0, 0.3), ("engine.plan", 0.3, 0.5),
                ("engine.derive", 0.5, 0.6), ("engine.kernel", 0.6, 0.65)]
        for name, a, b in kids if laps else kids[:1]:
            sid += 1
            spans.append(_span(name, sid, job, job, t + a, t + b))
    inside = [t for t in starts if 10 <= t <= 30]
    rec = {"window": (10.0, 30.0),
           "jobs": [{"start": t, "wall": 2.0, "ok": True} for t in inside]}
    return rec, spans


def test_dense_s():
    read = run.reader(ROOT, "dense_s")
    rec, spans = _dense_jobs([5.0, 10.0, 20.0])  # the first, the warm-up
    assert read(rec, spans) == pytest.approx(0.35)
    rec, spans = _dense_jobs([5.0, 10.0, 20.0], laps=False)
    assert read(rec, spans) is None
    rec, spans = _dense_jobs([10.0, 20.0])
    rec["jobs"].append({"start": 25.0, "wall": 2.0, "ok": True})
    assert read(rec, spans) is None


def test_dense_roofline():
    read = run.reader(ROOT, "dense_roofline")
    card = "NVIDIA H100 80GB HBM3"
    # 335 MB read once: 100 us a job; two jobs
    exp = {"input_residues": [335_000_000 - 12 * 1000 - 8 * 4],
           "input_rows": [1000], "rows": ["a", "b"], "cols": ["a", "b"],
           "pair_residues": 1000}
    ev = [("kernel", "void dense_match_kernel<1, 5>(Args)", 11.0, 11.002),
          ("kernel", "void (anonymous)::dense_onehot_kernel_ranges()",
           12.0, 12.001),
          ("kernel", "void tile_match_kernel<1, 5, true, false>()",
           13.0, 14.0),
          ("gpu_memcpy", "Memcpy HtoD", 15.0, 16.0),
          ("kernel", "void dense_join_kernel<2>()", 29.999, 30.001)]
    rec = {"window": (10.0, 30.0), "jobs": [{}, {}], "expected": exp,
           "card": card, "device_events": ev}
    # 200 us of bound over 2 + 1 + 1 ms of dense kernels in the window
    assert read(rec) == pytest.approx(5.0)
    rec["device_events"] = ev[2:4]
    assert read(rec) is None
    rec["device_events"] = []
    assert read(rec) is None
