"""The controls of `correct`: the reference put in the program's place,
computed below what the configuration states, judged by the same
comparison as the program's jobs. Each must come out not correct.

    python3 -m portbench.control --workload keck20.m-d1i --seeds 1,2,3

For each seed: make the cell's inputs, work out the reference's result,
then each control's (portbench/reference/<reference>.py CONTROLS:
float32 scores and sums in place of float64, or the indel matches left
out), and print the numbers compared (cells_off) as JSON lines. It runs
no program code and needs no card; run it on the machine of the cell.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time

from . import check
from .run import ROOT, cell, write_inputs


def readings(root: str, workload: str, seed: int) -> dict:
    """cells_off of each control of the cell against the reference, on
    the inputs of seed."""
    c = cell(root, workload)
    traffic = c["traffic"]
    ref = importlib.import_module(
        f"portbench.reference.{traffic['reference']}")
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        paths = write_inputs(c["config"], traffic, seed, workdir)
        t = time.perf_counter()
        want = check.expected_cells(ref.solve_cli(traffic["argv"], paths))
        out = {"workload": workload, "seed": seed,
               "reference_s": time.perf_counter() - t}
        for name in ref.CONTROLS:
            got = check.expected_cells(
                ref.solve_cli(traffic["argv"], paths, control=name))
            text = "\n".join("\t".join(line) for line in got) + "\n"
            out[name] = check.cells_off(text, want)
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    for seed in a.seeds.split(","):
        print(json.dumps(readings(ROOT, a.workload, int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
