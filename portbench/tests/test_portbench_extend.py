"""A cell, a configuration and a per-layer metric are added as files and
manifest entries alone: the harness lists the new cell and runs it, set
up and all, on the CPU, with no edit to its code."""

import io
import json
import os

from pb_small import small_root

from portbench import run


def test_new_cell_from_files_alone(tmp_path, monkeypatch):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    root = small_root(tmp_path)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "keck20.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tinyco"
    cfg["sets"]["cohort"].update(rows=1500, repertoires=4, gene_skew=0.0)
    with open(os.path.join(pb, "configs", "tinyco.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "m-d1.json"), "w") as f:
        json.dump({"why": "-m -d 1, no indels: the host pigeonhole route",
                   "argv": ["-m", "-d", "1"], "inputs": ["cohort"],
                   "env": {}, "reference": "overlap_d1"}, f)
    with open(os.path.join(pb, "metrics", "jobs_in_window.py"), "w") as f:
        f.write("def read(rec):\n    return len(rec['jobs'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "tinyco", "source": "a test",
                         "file": "portbench/configs/tinyco.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tinyco.m-d1", "config": "tinyco",
                           "traffic": "m-d1", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                           "better": "higher", "source": "program_counter",
                           "layer": "cli", "moves": "job_s",
                           "workloads": ["tinyco.m-d1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)

    names = [w["name"] for w in run.load_manifest(root)["workloads"]]
    assert "tinyco.m-d1" in names
    traffic = run.cell(root, "tinyco.m-d1")["traffic"]
    assert traffic["argv"] == ["-m", "-d", "1"]
    for trace in (False, True):
        out, err = io.StringIO(), io.StringIO()
        rc = run.execute("tinyco.m-d1", 2**31 + 5, 0.3, trace, root=root,
                         require_card=False, build=False, out=out, err=err)
        assert rc == 0, err.getvalue()[-2000:]
        res = json.loads(out.getvalue().splitlines()[-1])
        assert res["correct"] and res["attempted"] >= 1
        if trace:
            got = res["metrics"]["jobs_in_window"]["value"]
            assert got == res["attempted"]
            assert "match_roofline" not in res["metrics"]
        else:
            assert set(res["metrics"]) == {"job_s", "job_s_p95", "setup_s"}
        assert list(res)[-1] == run.CHECKS_KEY
