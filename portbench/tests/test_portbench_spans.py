"""The span metrics (portbench/spans.py and its readers in
portbench/metrics/) on hand-built records and span lists, and on a real
traced CPU run; the phase recorder still reads the program's unchanged
main-thread laps."""

import io
import json
import os
import sys
import threading
from types import SimpleNamespace

import pytest

from pb_small import small_root

from portbench import run
from portbench import trace as tr

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPAN_METRICS = ("worklist_s", "decode_s", "tile_yield", "route_host_idle")
NS = 10**9


def _span(name, sid, job, parent, t0, t1, **counts):
    return SimpleNamespace(name=name, id=sid, job=job, parent=parent,
                           thread=1, t0=int(t0 * NS), t1=int(t1 * NS),
                           counts=counts)


def _jobs(starts):
    """Spans of one job at each start (s), and the record of a window
    10..30 s holding those that start inside it."""
    spans, sid = [], 0
    for k, t in enumerate(starts):
        sid += 1
        job = sid
        spans.append(_span("job", job, job, None, t, t + 2))

        def kid(name, a, b, **c):
            nonlocal sid
            sid += 1
            spans.append(_span(name, sid, job, job, t + a, t + b, **c))

        kid("io.parse", 0.0, 0.5, rows=10)
        kid("engine.pack_keys", 0.6, 0.7)
        kid("engine.worklist", 0.7, 0.9)
        kid("engine.count", 0.9, 1.0, tiles=10, tiles_matched=4 + k)
        kid("engine.decode", 1.1, 1.15, pairs=3)
        kid("engine.decode", 1.2, 1.25, pairs=3)
        kid("engine.diagonal", 1.3, 1.4, pairs=9)
    inside = [t for t in starts if 10 <= t <= 30]
    rec = {"window": (10.0, 30.0),
           "jobs": [{"start": t, "wall": 2.0, "ok": True} for t in inside],
           # the card busy over the first half of each job's route work
           "busy": [[t + 0.6, t + 0.8] for t in inside]}
    return rec, spans


def _read(name, rec, spans):
    return run.reader(ROOT, name)(rec, spans)


def test_span_metrics_on_hand_built_spans():
    rec, spans = _jobs([5.0, 10.0, 20.0])  # the first is the warm-up
    assert _read("worklist_s", rec, spans) == pytest.approx(0.3)
    assert _read("decode_s", rec, spans) == pytest.approx(0.1)
    # jobs 1 and 2 of the list: (5 + 6) matched tiles of 20
    assert _read("tile_yield", rec, spans) == pytest.approx(55.0)
    # host work 0.6..0.9 (0.2 idle after the busy 0.6..0.8), 1.1..1.15,
    # 1.2..1.25, 1.3..1.4: 0.3 s a job idle, 0.6 s of 20
    assert _read("route_host_idle", rec, spans) == pytest.approx(3.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_on_a_job_mismatch(name):
    rec, spans = _jobs([10.0, 20.0])
    rec["jobs"].append({"start": 25.0, "wall": 2.0, "ok": True})
    assert _read(name, rec, spans) is None
    rec, spans = _jobs([10.0, 20.0])
    assert _read(name, rec, [s for s in spans if s.name != "job"]) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_the_record(name, monkeypatch):
    """A program with no utils.trace (the parent of the change that
    added it) gives no value, and no error."""
    rec, _spans = _jobs([10.0])
    monkeypatch.setitem(sys.modules, "compairr_tpu_torch.utils.trace", None)
    assert run.reader(ROOT, name)(rec) is None


def test_route_host_idle_needs_the_card():
    rec, spans = _jobs([10.0])
    rec["busy"] = []
    assert _read("route_host_idle", rec, spans) is None


def test_span_metrics_on_a_traced_cpu_run(tmp_path, monkeypatch):
    """The span metrics that do not need the card, read from the
    program's own spans in a traced run of the cell on the CPU."""
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    from compairr_tpu_torch.utils import trace

    root = small_root(tmp_path)
    for name in SPAN_METRICS:
        with open(os.path.join(ROOT, "portbench", "metrics",
                               f"{name}.py")) as f:
            src = f.read()
        with open(os.path.join(root, "portbench", "metrics",
                               f"{name}.py"), "w") as f:
            f.write(src)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    names = [n for n in SPAN_METRICS if n != "route_host_idle"]
    m["per_layer"] = [{"name": n, "unit": "s", "better": "lower",
                       "source": "program_span", "layer": "engine",
                       "moves": "job_s", "workloads": ["keck20.m-d1i"]}
                      for n in names]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    trace.reset()
    out, err = io.StringIO(), io.StringIO()
    try:
        rc = run.execute("keck20.m-d1i", 2**31 + 11, 0.3, True, root=root,
                         require_card=False, build=False, out=out, err=err)
    finally:
        monkeypatch.delenv("COMPAIRR_TIMING", raising=False)
        trace.reset()
        trace.refresh()
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"]
    got = {n: res["metrics"][n]["value"] for n in names}
    assert got["worklist_s"] > 0 and got["decode_s"] > 0
    assert 0 < got["tile_yield"] <= 100


def test_phase_recorder_reads_the_unchanged_laps(tmp_path, monkeypatch):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        from synth import make_tsv
    finally:
        sys.path.pop(0)
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.utils import trace

    a = make_tsv(str(tmp_path / "a.tsv"), 600, 4, seed=5, n_v=2, n_j=2,
                 len_range=(6, 9), alphabet_sub=3)
    trace.reset()
    try:
        with tr.PhaseRecorder() as rec:
            assert cli.main(["-m", "-d", "1", "-i", a, a,
                             "-o", str(tmp_path / "o.tsv")]) == 0
        spans = trace.spans()
    finally:
        trace.reset()
    main = threading.get_ident()
    laps = [(lb, s, e) for th, lb, s, e in rec.laps if th == main]
    assert [lb for lb, _, _ in laps] == [
        "read1", "read2", "prefetch", "dup_phase", "find_pairs",
        "accumulate", "write"]
    by_name = {s.name: s for s in spans if s.thread == main}
    for lb, s, e in laps:
        assert s == by_name[lb].t0 / 1e9 and e == by_name[lb].t1 / 1e9
    # the worker's laps are recorded too, on their own thread
    assert {"pack_keys", "worklist", "count", "extract"} <= {
        lb for th, lb, _, _ in rec.laps if th != main}
