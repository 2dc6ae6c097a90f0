"""Multi-host demo: per-host input shards merged into one run's matrix.

Each simulated host runs the port's CLI with COMPAIRR_INPUT_SHARD=k/n
(modes/overlap.py: the parser reads only its line-aligned chunk of set
1) against the full set 2, producing a partial overlap matrix in the
three-column format. The partial matrices merge by (repertoire_1,
repertoire_2), which is exact because every matched pair is counted by
exactly one host (set 1's rows partition across hosts). The merge is
asserted equal to a single-process run.

This automates the reference README's manual split-and-merge advice and
is the host-level half of the multi-host story; the device-level half
is parallel/mesh.py and the tile route's device split, and the CLI joins
a torch.distributed process group under COMPAIRR_DISTRIBUTED or
torchrun's MASTER_ADDR.

Usage: python -m compairr_tpu_torch.scripts.multihost_demo [--hosts N]
    [--n ROWS] [-d D]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cli(args, extra_env=None):
    env = dict(os.environ)
    if extra_env:
        env.update(extra_env)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "compairr_tpu_torch", *args],
        check=True, cwd=REPO, env=env,
    )
    return time.perf_counter() - t0


def read_threecol(path):
    out = {}
    with open(path) as f:
        header = f.readline()
        if not header.startswith("#"):
            raise ValueError(f"{path}: not a three-column matrix")
        for line in f:
            r1, r2, v = line.rstrip("\n").split("\t")
            out[(r1, r2)] = out.get((r1, r2), 0.0) + float(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("-d", type=int, default=1)
    args = ap.parse_args(argv)

    from .scale_demo import generate

    with tempfile.TemporaryDirectory() as td:
        a = os.path.join(td, "a.tsv")
        b = os.path.join(td, "b.tsv")
        generate(a, args.n, reps=24, seed=51)
        generate(b, args.n, reps=24, seed=52)

        flags = ["-m", "-d", str(args.d), "-a", a, b]

        full = os.path.join(td, "full.tsv")
        t_full = run_cli(flags + ["-o", full, "-l", os.devnull])
        merged = {}
        t_hosts = []
        for k in range(args.hosts):
            part = os.path.join(td, f"part{k}.tsv")
            t = run_cli(
                flags + ["-o", part, "-l", os.devnull],
                extra_env={"COMPAIRR_INPUT_SHARD": f"{k}/{args.hosts}"},
            )
            t_hosts.append(t)
            for key, v in read_threecol(part).items():
                merged[key] = merged.get(key, 0.0) + v

        want = read_threecol(full)
        # hosts whose chunk lacks a repertoire contribute no rows for it;
        # zero cells must compare equal either way
        keys = set(want) | set(merged)
        for key in keys:
            got = merged.get(key, 0.0)
            exp = want.get(key, 0.0)
            if got != exp:
                raise AssertionError(
                    f"cell {key}: merged {got}, one run {exp}")

        print(
            f"multihost_demo: OK: {args.hosts} sharded runs merge exactly "
            f"into the single-run matrix ({len(keys)} cells).\n"
            f"single-process wall: {t_full:.1f}s; per-host walls: "
            + ", ".join(f"{t:.1f}s" for t in t_hosts)
            + f"; max {max(t_hosts):.1f}s (on several hosts these run "
            f"concurrently)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
