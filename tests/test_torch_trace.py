"""The port's span record (compairr_tpu_torch/utils/trace.py): one span
tree a CLI job under COMPAIRR_TIMING=1, the tile route's worker inside
it, counts that agree with the job's own results, the cap on each job,
the spans as torch.profiler annotations, and nothing recorded,
allocated or imported (torch) when it is off or on a host route. On the
CPU (COMPAIRR_DEVICE=cpu)."""

import contextvars
import glob
import json
import os
import subprocess
import sys
import threading
import tracemalloc

import pytest

from torch_port_data import write_pair

from compairr_tpu_torch import cli
from compairr_tpu_torch.ops import engine
from compairr_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    trace.reset()
    yield
    trace.reset()
    monkeypatch.delenv("COMPAIRR_TIMING")
    trace.refresh()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    a, b = write_pair(d)
    return a, b, d


def _rows(path):
    with open(path) as f:
        return sum(1 for _ in f) - 1


def _job(argv):
    assert cli.main(list(argv)) == 0
    spans = trace.spans()
    jobs = [s for s in spans if s.name == "job"]
    assert len(jobs) == 1
    return jobs[0], spans


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_one_tree_a_job_with_the_worker_inside(traced, pair):
    a, _b, d = pair
    job, spans = _job(["-m", "-d", "1", "-i", a, a, "-o", str(d / "o1")])
    assert job.parent is None and job.t0 < job.t1
    ids = {s.id for s in spans}
    for s in spans:
        assert s.job == job.id, s.name
        assert s is job or s.parent in ids, s.name
        assert s.t0 <= s.t1, s.name
    (fp,) = _named(spans, "engine.find_pairs")
    assert fp.parent == job.id and fp.thread != job.thread
    assert fp.counts["route"] == "tiles" and fp.counts["tile"] == 128
    (join,) = _named(spans, "engine.join")
    assert join.thread == job.thread
    # the route's phases sit under the worker's span, on the worker
    for name in ("engine.pack_keys", "engine.rows_raw", "engine.worklist",
                 "engine.count", "engine.distances", "engine.diagonal"):
        (s,) = _named(spans, name)
        assert s.parent == fp.id and s.thread == fp.thread, name
    # one extract_tiles launch a class stream, one decode a device
    extracts = _named(spans, "kernels.extract")
    assert 1 <= len(extracts) <= 3  # the tile classes
    (decode,) = _named(spans, "engine.decode")
    assert {s.parent for s in extracts + [decode]} == {
        _named(spans, "engine.extract")[0].parent} == {fp.id}
    # the main thread's laps, unchanged
    laps = [s.name for s in spans if s.thread == job.thread
            and s.parent == job.id and "." not in s.name]
    assert laps == ["read1", "read2", "prefetch", "dup_phase",
                    "find_pairs", "accumulate", "write"]
    assert job.counts["spans_dropped"] == 0


def test_counts_agree_with_the_job(traced, pair):
    a, b, d = pair
    pairs = d / "pairs.tsv"
    job, spans = _job(["-m", "-d", "1", "-i", "-p", str(pairs), a, b,
                       "-o", str(d / "o2")])
    written = _rows(pairs)
    assert written > 0
    (diag,) = _named(spans, "engine.diagonal")
    (dist,) = _named(spans, "engine.distances")
    (acc,) = _named(spans, "modes.accumulate")
    assert diag.counts["pairs"] == written == acc.counts["pairs"]
    # two sets: no diagonal is added, so the decoded pairs are all
    assert dist.counts["pairs"] == written
    # the derive's plain version on the CPU launches nothing
    (derive,) = _named(spans, "engine.rows_raw")
    assert derive.counts["derive_launches"] == 0
    assert sum(s.counts["pairs"] for s in _named(spans, "engine.decode")) \
        == written
    (wl,) = _named(spans, "engine.worklist")
    (cnt,) = _named(spans, "engine.count")
    tiles = sum(v for k, v in wl.counts.items() if k.startswith("tiles."))
    assert cnt.counts["tiles"] == tiles > 0
    assert 0 < cnt.counts["tiles_matched"] <= tiles
    extracts = _named(spans, "kernels.extract")
    assert sum(s.counts["pairs"] for s in extracts) == written
    assert sum(s.counts["tiles"] for s in extracts) \
        == cnt.counts["tiles_matched"]
    (decode,) = _named(spans, "engine.decode")
    assert decode.counts["d2h_bytes"] == 0  # the CPU: nothing copied
    parses = _named(spans, "io.parse")
    assert [s.counts["rows"] for s in parses] == [_rows(a), _rows(b)]
    assert [s.counts["input_bytes"] for s in parses] == [
        os.path.getsize(a), os.path.getsize(b)]
    assert [s.counts["repertoires"] for s in _named(spans, "modes.stats")] \
        == [5, 7]
    assert [s.counts["rows"] for s in _named(spans, "core.dup")] == [
        _rows(a), _rows(b)]
    (srt,) = _named(spans, "modes.sort")
    assert srt.counts["pairs"] == written
    (wr,) = _named(spans, "modes.write")
    assert wr.counts["bytes"] == os.path.getsize(d / "o2")


def test_phase_report_is_read_from_the_spans(traced, capsys):
    tm = engine._PhaseTimer("engine")
    tm.mark()
    tm.add("pairs", 3)
    tm.lap("a")
    tm.lap("b")
    tm.lap("a")
    tm.report("probe n=1")
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("[timing] probe n=1: a=")
    spans = trace.spans()
    assert [s.name for s in spans] == ["engine.a", "engine.b", "engine.a"]
    assert spans[0].counts == {"pairs": 3} and spans[1].counts == {}
    assert spans[0].t1 == spans[1].t0 and spans[1].t1 == spans[2].t0
    parts = dict(kv.split("=") for kv in err[0].split(": ")[1].split())
    want = (spans[0].t1 - spans[0].t0 + spans[2].t1 - spans[2].t0) / 1e9
    assert parts["a"] == f"{want:.6f}s"
    assert tm._t == spans[2].t1 / 1e9


def test_off_records_and_allocates_nothing(pair, tmp_path, monkeypatch):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.delenv("COMPAIRR_TIMING", raising=False)
    trace.reset()
    a, _b, _d = pair
    assert cli.main(["-m", "-d", "1", "-i", a, a,
                     "-o", str(tmp_path / "o.tsv")]) == 0
    assert trace.spans() == [] and not trace.ON
    assert trace.span("x") is trace.NULL and not trace.NULL
    assert trace.record("x", 0, 1) is trace.NULL

    def calls():
        for _ in range(1000):
            with trace.span("x") as sp:
                sp.count("n", 1)
                trace.count("n", 1)
                trace.note("route", "tiles")
                trace.count_job("n", 1)

    calls()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    flt = [tracemalloc.Filter(True, trace.__file__)]
    grown = after.filter_traces(flt).compare_to(
        before.filter_traces(flt), "lineno")
    assert sum(st.count_diff for st in grown) == 0


@pytest.mark.parametrize("where", ["main", "worker"])
def test_cap_counts_the_spans_dropped(traced, monkeypatch, where):
    """Past CAP spans under one job, the job counts the rest as dropped,
    whichever thread opens them; the job itself is always kept."""
    monkeypatch.setattr(trace, "CAP", 3)

    def five():
        for _ in range(5):
            with trace.span("x"):
                pass

    with trace.job() as job:
        if where == "main":
            five()
        else:
            t = threading.Thread(target=contextvars.copy_context().run,
                                 args=(five,))
            t.start()
            t.join()
    assert [s.name for s in trace.spans()] == ["job", "x", "x", "x"]
    assert job.counts["spans_dropped"] == 2


def test_cap_is_per_job(traced, monkeypatch):
    """A job that fills its share drops its own spans only: the next
    job keeps its root and every span under it."""
    monkeypatch.setattr(trace, "CAP", 2)
    with trace.job() as full:
        for _ in range(4):
            with trace.span("x"):
                pass
    with trace.job() as nxt:
        with trace.span("y"):
            trace.record("z", 0, 1)
    assert full.counts["spans_dropped"] == 2
    assert nxt.counts["spans_dropped"] == 0
    kept = trace.spans()
    assert [s.name for s in kept] == ["job", "x", "x", "job", "y", "z"]
    assert [s.job for s in kept[3:]] == [nxt.id] * 3


def test_spans_are_profiler_annotations(traced, pair, tmp_path,
                                        monkeypatch):
    import torch

    monkeypatch.setenv("COMPAIRR_PROFILE", str(tmp_path / "prof"))
    a, _b, _d = pair
    _job(["-m", "-d", "1", "-i", a, a, "-o", str(tmp_path / "o.tsv")])
    (path,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"io.parse", "modes.stats", "core.dup", "engine.join",
            "modes.accumulate", "modes.write"} <= names
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return  # this torch records the calling thread alone
    assert {"engine.find_pairs", "kernels.extract", "engine.decode"} <= names


def test_host_route_traced_without_torch(tmp_path):
    """A traced -d 2 run resolves on the host pigeonhole: spans are
    recorded and torch is never imported."""
    a, b = write_pair(tmp_path)
    code = (
        "import sys\n"
        "from compairr_tpu_torch.cli import main\n"
        "from compairr_tpu_torch.utils import trace\n"
        f"main(['-m', '-d', '2', {a!r}, {b!r}, '-o', "
        f"{str(tmp_path / 'o.tsv')!r}])\n"
        "assert 'torch' not in sys.modules\n"
        "names = [s.name for s in trace.spans()]\n"
        "assert names[0] == 'job' and 'engine.find_pairs' in names, names\n"
        "assert 'engine.group_p0' in names, names\n"
        "print('hostonly')\n"
    )
    env = dict(os.environ, COMPAIRR_TIMING="1")
    env.pop("COMPAIRR_PROFILE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "hostonly" in proc.stdout, proc.stderr
