"""A traced run fails loudly where it cannot read what the cell lists:
no phase timer in the program, a trace whose job spans do not match the
jobs, a metric that reads nothing."""

import io
import json
import os

import pytest

from pb_small import small_root

from portbench import run
from portbench import trace as tr


def test_recorder_needs_the_phase_timer(monkeypatch):
    from compairr_tpu_torch.ops import engine

    monkeypatch.delattr(engine, "_PhaseTimer")
    with pytest.raises(RuntimeError, match="_PhaseTimer"):
        with tr.PhaseRecorder():
            pass


def test_spans_must_match_the_jobs(tmp_path):
    path = str(tmp_path / "trace.json")
    span = {"name": tr.JOB_SPAN, "cat": "user_annotation", "ph": "X",
            "ts": 1e6, "dur": 10}
    kernel = {"name": "k", "cat": "kernel", "ph": "X", "ts": 1e6 + 5,
              "dur": 2}
    with open(path, "w") as f:
        json.dump({"traceEvents": [span, kernel]}, f)
    got = tr.device_events(path, [7.0])
    assert got == [("kernel", "k", pytest.approx(7.000005),
                    pytest.approx(7.000007))]
    with pytest.raises(RuntimeError, match="spans for 2 jobs"):
        tr.device_events(path, [7.0, 8.0])


def test_metric_that_reads_nothing_fails_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    root = small_root(tmp_path)
    with open(os.path.join(root, "portbench", "metrics", "empty.py"),
              "w") as f:
        f.write("def read(rec):\n    return None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["per_layer"].append({"name": "empty", "unit": "s", "better": "lower",
                           "source": "program_span", "layer": "cli",
                           "moves": "job_s", "workloads": ["keck20.m-d1i"]})
    m["per_layer"] = [e for e in m["per_layer"]
                      if e["name"] in ("parse_s", "empty")]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    out, err = io.StringIO(), io.StringIO()
    rc = run.execute("keck20.m-d1i", 2**31 + 9, 0.2, True, root=root,
                     require_card=False, build=False, out=out, err=err)
    assert rc == 5 and out.getvalue() == ""
    assert "metric empty read nothing" in err.getvalue()
