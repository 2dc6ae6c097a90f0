"""A copy of the benchmark's data files under a temporary root, with
the cohorts cut to a size that the CPU runs in seconds."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def small_root(tmp, rows=3000, repertoires=None):
    root = os.path.join(str(tmp), "root")
    os.makedirs(os.path.join(root, "portbench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        os.path.join(root, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(os.path.join(root, "portbench", "configs")):
        path = os.path.join(root, "portbench", "configs", name)
        with open(path) as f:
            c = json.load(f)
        c["sets"]["cohort"]["rows"] = rows
        if repertoires:
            c["sets"]["cohort"]["repertoires"] = repertoires
        with open(path, "w") as f:
            json.dump(c, f)
    return root
