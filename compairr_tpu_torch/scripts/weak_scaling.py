"""Weak scaling of the dense engine over 1, 2, 4, ... shards.

Weak scaling: each shard gets a constant workload, so ideal scaling keeps
the wall flat as shards are added. Set 1 is k concatenated copies of one
base block (identical rows a shard, so identical worklists by
construction); set 2 is that base block, so the matrix checksum scales
exactly linearly with k, a workload with output, not an empty worklist.

Runs parallel.mesh.dense_matrix_sharded (set 2 whole on every device,
one all-reduce) or, under --mode ring, dense_matrix_ring (set 2 in spans
handed round) over the first 1, 2, 4, ... shards of a device list: by
default utils.device.local_devices() (the local cards, or the CPU under
COMPAIRR_DEVICE=cpu); --devices N takes N shards in turn over those
devices ([cuda:0] * N on one card, [cpu] * N on the CPU).

Two efficiencies are reported:
  efficiency       = t(1) / t(k), only when the k shards sit on k
                     distinct devices (None otherwise): the number to
                     quote for several cards.
  core_normalized  = k * t(1) / t(k), only when all k shards share one
                     device (None otherwise): there even a perfectly
                     scaling program serialises to k * t(1), so values
                     near 1.0 mean the split adds little beyond that.

Usage:
  python -m compairr_tpu_torch.scripts.weak_scaling [--per-device 20000]
      [--mode ring] [--devices N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def tile_db(base, k: int):
    """k stacked copies of a SeqDB (the weak-scaling workload)."""
    if k == 1:
        return base
    # the array fields below are every per-row field this script's sets
    # carry; a native-parsed db would also carry row_hash, which this
    # builder does not tile, so it is refused
    if base.row_hash is not None:
        raise ValueError("tile_db does not tile row_hash")
    return dataclasses.replace(
        base,
        seqs=np.tile(base.seqs, (k, 1)),
        lengths=np.tile(base.lengths, k),
        counts=np.tile(base.counts, k),
        rep_no=np.tile(base.rep_no, k),
        v_no=np.tile(base.v_no, k),
        j_no=np.tile(base.j_no, k),
        sequence_ids=list(base.sequence_ids) * k,
        keep=list(base.keep) * k,
        residues_count=base.residues_count * k,
        total_dup_count=base.total_dup_count * k,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=20_000)
    ap.add_argument("--mode", choices=["sharded", "ring"],
                    default="sharded")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards, taken in turn over the local devices")
    args = ap.parse_args(argv)

    from ..bench import synth_arrays
    from ..constants import SCORE_PRODUCT
    from ..ops.engine import MatchSpec
    from ..parallel import mesh
    from ..utils.device import local_devices

    local = local_devices()
    nmax = args.devices or len(local)
    devices = [local[i % len(local)] for i in range(nmax)]
    spec = MatchSpec(differences=1, indels=False, ignore_genes=False)
    run = (mesh.dense_matrix_ring if args.mode == "ring"
           else mesh.dense_matrix_sharded)

    base = synth_arrays(args.per_device, n_reps=12, n_v=16, n_j=6, seed=76)
    results = []
    t1 = c1 = None
    counts = [1]
    while counts[-1] * 2 <= nmax:
        counts.append(counts[-1] * 2)
    for ndev in counts:
        d1 = tile_db(base, ndev)
        devs = devices[:ndev]
        distinct = len(set(devs))
        # warm (the kernels' lazy build, the cards' first use), then
        # the best of 3
        run(d1, base, spec, SCORE_PRODUCT, False, devices=devs)
        best = float("inf")
        best_stats = {}
        for _ in range(3):
            t0 = time.perf_counter()
            m = run(d1, base, spec, SCORE_PRODUCT, False, devices=devs)
            w = time.perf_counter() - t0
            if w < best:
                best, best_stats = w, dict(mesh.LAST_STATS)
        if t1 is None:
            t1 = best
            c1 = best_stats.get("compute_s")
        core_norm = ndev * t1 / best if distinct == 1 else None
        if core_norm is not None and core_norm > ndev:
            # t(k) < t(1) on one shared device is a measurement anomaly
            # (host noise): surfaced, not clamped
            print(f"WARNING: core_normalized {core_norm:.2f} > {ndev} "
                  f"(t({ndev}) < t(1)): noisy measurement", file=sys.stderr)
        r = dict(devices=ndev, distinct_devices=distinct, rows1=d1.n,
                 wall_s=best,
                 efficiency=t1 / best if distinct == ndev else None,
                 core_normalized=core_norm,
                 checksum=float(m.sum()))
        # overhead attribution: pack/shard/put are host work here, but
        # per-host parallel over several hosts (COMPAIRR_INPUT_SHARD), so
        # compute_s is the weak-scaling figure of the split itself;
        # pad_fraction is the share of the longest shard's worklist the
        # others lack
        cs = best_stats.get("compute_s")
        r.update(
            compute_s=cs,
            prep_s=best - cs if cs is not None else None,
            pack_s=best_stats.get("pack_s"),
            shard_s=best_stats.get("shard_s"),
            put_s=best_stats.get("put_s"),
            real_tiles=best_stats.get("real_tiles"),
            padded_tiles_per_shard=best_stats.get("padded_tiles_per_shard"),
            pad_fraction=best_stats.get("pad_fraction"),
        )
        if cs and c1 and distinct == 1:
            r["compute_core_normalized"] = ndev * c1 / cs
        results.append(r)
        print(json.dumps(results[-1]), flush=True)

    # the workload makes the checksum exactly linear, and the sums are
    # int64 (exact in any order) turned into float64 below 2^53
    if not all(r["checksum"] == r["devices"] * results[0]["checksum"]
               for r in results):
        raise AssertionError(
            "matrix checksum must scale exactly linearly: "
            f"{[(r['devices'], r['checksum']) for r in results]}")

    summary = dict(
        metric=f"weak-scaling ({args.mode}, {nmax} shards over "
               f"{sorted(set(map(str, devices)))})",
        per_device_rows=args.per_device,
        efficiency_at_max=results[-1]["efficiency"],
        core_normalized_at_max=results[-1]["core_normalized"],
        compute_core_normalized_at_max=results[-1].get(
            "compute_core_normalized"),
        results=results,
    )
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
