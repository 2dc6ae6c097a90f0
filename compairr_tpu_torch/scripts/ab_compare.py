"""Same-window A/B comparison of two trees of the port.

Card and host timings drift between calls and machines, so a claim that
compares run X (yesterday) against run Y (now) is unsound. The protocol:

1. unpack the baseline tree into a directory of its own
   (`git archive <commit> | tar -x -C <dir>`);
2. run the SAME probe against both trees, in turns A B A B ..., one
   process a run so that nothing built or cached leaks between trees;
3. claim only the per-tree best across rounds.

This script automates 2-3:

    python -m compairr_tpu_torch.scripts.ab_compare <tree_a> <tree_b> \\
        --rounds 4 -- compairr_tpu_torch/scripts/ab_probe_count.py

Each probe run is `python <probe> <tree> [probe-args]`, with the tree
put first on PYTHONPATH (the probe also puts it first on sys.path); the
probe must print a line `ABRESULT <seconds> [label=value ...]`. The
script interleaves the trees, parses those lines and reports each
tree's best and all samples, and the ratio of the bests.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_probe(probe: str, tree: str, extra: list[str]) -> tuple[float, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [tree] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, probe, tree, *extra],
        env=env, capture_output=True, text=True,
    )
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"probe failed under tree {tree}")
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("ABRESULT "):
            result = line
    if result is None:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"probe under {tree} printed no ABRESULT line")
    secs = float(result.split()[1])
    return secs, result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="interleaved same-window A/B comparison"
    )
    ap.add_argument("tree_a", help="baseline tree")
    ap.add_argument("tree_b", help="candidate tree")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument(
        "probe", nargs="+",
        help="probe script (+args); its printed line 'ABRESULT <secs> ...' "
             "is the sample",
    )
    args = ap.parse_args(argv)

    samples: dict[str, list[float]] = {args.tree_a: [], args.tree_b: []}
    for rnd in range(args.rounds):
        for tree in (args.tree_a, args.tree_b):
            secs, line = run_probe(args.probe[0], tree, args.probe[1:])
            samples[tree].append(secs)
            print(f"round {rnd} tree={tree}: {line}", flush=True)

    mins = {t: min(v) for t, v in samples.items()}
    print()
    for tree, vals in samples.items():
        print(f"{tree}: min={min(vals):.6f}s  samples="
              + " ".join(f"{v:.6f}" for v in vals))
    ratio = mins[args.tree_a] / mins[args.tree_b]
    print(f"speedup (A_min / B_min): {ratio:.3f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
