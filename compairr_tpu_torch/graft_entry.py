"""The port's entry points: entry(), one dense kernel call on two
small synthetic sets, and dryrun_multichip, the multi-device dry run.
The counterparts of the JAX package's __graft_entry__.py, with their own
copy of that file's synthetic sets (the same numpy seeds, so the same
rows).

    COMPAIRR_DEVICE=cpu python -c \\
        "from compairr_tpu_torch.graft_entry import entry; \\
step, args = entry(); print(step(*args).sum())"
    COMPAIRR_DEVICE=cpu python -c \\
        "from compairr_tpu_torch.graft_entry import dryrun_multichip; \\
dryrun_multichip(8)"
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def _synthetic_db(n, n_reps, seed, lmax=16):
    """A small in-memory SeqDB, without file io."""
    from .core.db import GeneTables, SeqDB

    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, lmax + 1, size=n).astype(np.int32)
    seqs = np.full((n, lmax), 20, dtype=np.int8)
    for i in range(n):
        seqs[i, : lengths[i]] = rng.integers(0, 20, size=lengths[i])
    genes = GeneTables()
    for k in range(4):
        genes.intern_v(f"V{k}")
    for k in range(3):
        genes.intern_j(f"J{k}")
    return SeqDB(
        nucleotides=False,
        seqs=seqs,
        lengths=lengths,
        counts=rng.integers(1, 5, size=n).astype(np.int64),
        rep_no=rng.integers(0, n_reps, size=n).astype(np.int32),
        v_no=rng.integers(0, 4, size=n).astype(np.int32),
        j_no=rng.integers(0, 3, size=n).astype(np.int32),
        sequence_ids=[f"S{i}" for i in range(n)],
        keep=[None] * n,
        repertoire_ids=[f"R{r}" for r in range(n_reps)],
        genes=genes,
        residues_count=int(lengths.sum()),
        total_dup_count=n,
        shortest=int(lengths.min()),
        longest=int(lengths.max()),
    )


def _plant(d1, d2, k, seed):
    """Copy k random rows of d1 over k random rows of d2 (residues,
    length, V and J), the first k // 2 of them with one substitution."""
    rng = np.random.default_rng(seed)
    src = rng.choice(d1.n, size=k, replace=False)
    dst = rng.choice(d2.n, size=k, replace=False)
    d2.seqs[dst] = d1.seqs[src]
    d2.lengths[dst] = d1.lengths[src]
    d2.v_no[dst] = d1.v_no[src]
    d2.j_no[dst] = d1.j_no[src]
    d2.seqs[dst[: k // 2], 0] = (d2.seqs[dst[: k // 2], 0] + 1) % 20


def _entry_dbs(planted=False):
    """entry()'s two 512-row sets (seeds 1 and 2, 4 repertoires), which
    hold no pair within d=2; planted copies 32 rows of set 1 into set 2
    (seed 3), so that the sums are not all zero."""
    d1 = _synthetic_db(512, 4, seed=1)
    d2 = _synthetic_db(512, 4, seed=2)
    if planted:
        _plant(d1, d2, 32, seed=3)
    return d1, d2


def entry(device=None, planted=False):
    """One step of the dense overlap accumulation, the flagship kernel:
    (step, example_args), where step(a_rows, b_rows, work) returns the
    raw int64 [r1p, r2p] sums of the plan's kernel (dense_match here)
    over the whole worklist of two 512-row sets (seeds 1 and 2, 4
    repertoires, d=2, product, 128-row tiles), as engine.dense_span
    calls it; example_args are both sets' derived rows and the uploaded
    worklist. planted=True takes _entry_dbs' planted sets, whose sums
    are not all zero. Runs on `device`, by default COMPAIRR_DEVICE's or
    CUDA (utils.device.resolve_device, which raises with no card)."""
    from functools import partial

    from .constants import SCORE_PRODUCT
    from .ops import engine as E
    from .ops import kernels as K
    from .utils.device import resolve_device

    dev = resolve_device(device)
    d1, d2 = _entry_dbs(planted)
    spec = E.MatchSpec(differences=2, indels=False, ignore_genes=False)
    plan = E.dense_plan(d1, d2, spec, SCORE_PRODUCT, False)
    a = E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a, dev)
    b = E.dense_side(plan, d2, plan.order_b, plan.key_b, plan.npad_b, dev)
    example_args = (a.rows, b.rows, K.upload_worklist(plan.work, dev))
    return partial(E.dense_launch, plan), example_args


def _dryrun_dbs():
    """The dry run's pair of sets, with near-duplicates planted so that
    the matrix is not all zero, and its -d 1 -i spec; the multi-process
    worker computes over the same sets."""
    from .ops.engine import MatchSpec

    d1 = _synthetic_db(256, 3, seed=11)
    d2 = _synthetic_db(256, 3, seed=12)
    _plant(d1, d2, 32, seed=13)
    spec = MatchSpec(differences=1, indels=True, ignore_genes=False)
    return d1, d2, spec


def _write_tsvs(td: str) -> tuple[str, str]:
    rng = np.random.default_rng(17)
    paths = []
    for name, n in (("a.tsv", 300), ("b.tsv", 240)):
        path = os.path.join(td, name)
        with open(path, "w") as f:
            f.write("repertoire_id\tsequence_id\tduplicate_count\t"
                    "v_call\tj_call\tjunction_aa\n")
            for i in range(n):
                s = "".join("ACD"[c]
                            for c in rng.integers(0, 3, rng.integers(6, 9)))
                f.write(f"R{int(rng.integers(3))}\tS{i}\t1\t"
                        f"V{int(rng.integers(2))}\tJ{int(rng.integers(2))}"
                        f"\t{s}\n")
        paths.append(path)
    return paths[0], paths[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded and ring dense matrices over n_devices shards equal to
    one device's; a CLI -m -d 1 -i run with a pairs file (the tile
    route's device split) byte-equal on 1 and n_devices devices; and two
    processes (torch.distributed, gloo on the CPU and on one shared
    card) whose sharded and ring matrices equal one device's. The
    shards take the local devices in turn (utils.device.local_devices of
    `device`, by default COMPAIRR_DEVICE's or CUDA), so one device may
    hold several. Raises on any difference."""
    from . import cli
    from .constants import SCORE_PRODUCT
    from .ops.engine import dense_matrix
    from .parallel import worker
    from .parallel.mesh import dense_matrix_ring, dense_matrix_sharded
    from .utils import device as D

    local = D.local_devices(device)
    devices = [local[i % len(local)] for i in range(n_devices)]

    d1, d2, spec = _dryrun_dbs()
    single = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False,
                          device=devices[0])
    assert single.sum() > 0, "dryrun data produced no matches"
    sharded = dense_matrix_sharded(d1, d2, spec, SCORE_PRODUCT, False,
                                   devices=devices)
    np.testing.assert_array_equal(sharded, single)
    ring = dense_matrix_ring(d1, d2, spec, SCORE_PRODUCT, False,
                             devices=devices)
    np.testing.assert_array_equal(ring, single)

    # the CLI's tile route over 1 and n_devices devices
    saved_env = {k: os.environ.get(k)
                 for k in ("COMPAIRR_PIGEONHOLE", "COMPAIRR_DEVICE")}
    with tempfile.TemporaryDirectory() as td:
        a, b = _write_tsvs(td)
        outs = {}
        try:
            os.environ["COMPAIRR_PIGEONHOLE"] = "0"
            os.environ["COMPAIRR_DEVICE"] = devices[0].type
            for n in (1, n_devices):
                out = os.path.join(td, f"out{n}.tsv")
                pairs = os.path.join(td, f"pairs{n}.tsv")
                rc = cli.main(["-m", a, b, "-d", "1", "-i", "-o", out,
                               "-p", pairs,
                               "-l", os.path.join(td, f"log{n}.txt")],
                              devices=devices[:n])
                assert rc == 0
                with open(out, "rb") as f, open(pairs, "rb") as g:
                    outs[n] = (f.read(), g.read())
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    assert outs[1] == outs[n_devices], (
        "CLI output differs between 1 and multi-device runs")
    assert len(outs[1][1].splitlines()) > 1, "no matched pairs"

    results = worker.launch(nproc=2, local_devices=max(2, n_devices // 2),
                            device=devices[0].type)
    for dsh, dri in results.values():
        np.testing.assert_array_equal(dsh, single)
        np.testing.assert_array_equal(dri, single)

    print(f"dryrun_multichip({n_devices}): OK: sharded and ring [R1, R2] "
          f"matrix sum {sharded.sum():.0f} equal to one device's; CLI "
          f"--matrix/--pairs byte-equal on 1 and {n_devices} devices; 2 "
          f"processes (torch.distributed) equal to one device's")
