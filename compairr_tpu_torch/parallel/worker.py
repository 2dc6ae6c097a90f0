"""One rank of a multi-process run of the dense paths, and its launcher.

The launcher starts `nproc` ranks of

    python -m compairr_tpu_torch.parallel.worker RANK NPROC URL OUTDIR \\
        LOCAL_DEVICES DEVICE CASE

on this host, joined by torch.distributed at URL (tcp://localhost:PORT).
Each rank takes LOCAL_DEVICES shards on DEVICE ("cpu", or "cuda": its
own cards in turn, mesh.rank_devices, over nccl; on a host with fewer
cards than ranks they share one over gloo, as NCCL refuses two ranks on
one card), runs dense_matrix_sharded and dense_matrix_ring over all ranks'
shards (cross-rank all_reduce and ring hand-offs) on the sets that CASE,
a "module:function" returning their keyword arguments, makes from its
seeds, and saves both matrices and its LAST_STATS under OUTDIR. Every
rank must reproduce the single-process matrix.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Sequence

DRYRUN_CASE = "compairr_tpu_torch.parallel.worker:dryrun_case"


def dryrun_case() -> dict:
    """graft_entry's dryrun sets: planted near-duplicates, -d 1 -i,
    product score."""
    from ..constants import SCORE_PRODUCT
    from ..graft_entry import _dryrun_dbs

    d1, d2, spec = _dryrun_dbs()
    return dict(db1=d1, db2=d2, spec=spec, score_int=SCORE_PRODUCT,
                ignore_counts=False)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc: int = 2, local_devices: int | Sequence[int] = 4,
           device=None, timeout: float = 300, case: str = DRYRUN_CASE,
           out_dir: str | None = None) -> dict:
    """Run `nproc` ranks with `local_devices` shards each (or, given a
    list, rank r with local_devices[r]) on `device` (by default
    COMPAIRR_DEVICE's or CUDA, utils.device.resolve_device: raises when
    CUDA is asked for and absent), wait for all, and return
    {rank: (sharded, ring)}, the matrices each rank saved (its
    LAST_STATS of both runs stay in out_dir as stats_RANK.json when
    out_dir is given). Raises when a rank exits non-zero (the others are
    then stopped) or the run outlasts `timeout` seconds."""
    import tempfile

    import numpy as np

    from ..utils.device import resolve_device

    kind = resolve_device(device).type
    per_rank = ([local_devices] * nproc if isinstance(local_devices, int)
                else list(local_devices))

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["LOCAL_WORLD_SIZE"] = str(nproc)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "COMPAIRR_DISTRIBUTED"):
        env.pop(k, None)  # each rank joins the launcher's group only
    url = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as td:
        out = out_dir or td
        logs = [open(os.path.join(td, f"log_{r}.txt"), "w+")
                for r in range(nproc)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "compairr_tpu_torch.parallel.worker",
                 str(r), str(nproc), url, out, str(per_rank[r]), kind,
                 case],
                cwd=root, env=dict(env, LOCAL_RANK=str(r)),
                stdout=logs[r], stderr=subprocess.STDOUT,
            )
            for r in range(nproc)
        ]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nproc} ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {r} of {nproc} failed (rc={p.returncode}):\n"
                    + texts[r][-4000:]
                )
        return {
            r: (np.load(os.path.join(out, f"sharded_{r}.npy")),
                np.load(os.path.join(out, f"ring_{r}.npy")))
            for r in range(nproc)
        }


def main(argv: list[str]) -> int:
    rank, nproc, url, out, n_local, device, case = argv
    rank, nproc, n_local = int(rank), int(nproc), int(n_local)

    import importlib

    import numpy as np

    from ..utils.device import resolve_device
    from . import mesh

    backend = mesh.initialize_distributed(url, nproc, rank,
                                          mesh.choose_backend(device))
    module, _, fn = case.partition(":")
    kwargs = getattr(importlib.import_module(module), fn)()
    own = mesh.rank_devices(resolve_device(device))
    devices = [own[i % len(own)] for i in range(n_local)]
    stats = {}
    for name, fn in (("sharded", mesh.dense_matrix_sharded),
                     ("ring", mesh.dense_matrix_ring)):
        t0 = time.perf_counter()
        m = fn(**kwargs, devices=devices)
        stats[name] = dict(mesh.LAST_STATS, wall_s=time.perf_counter() - t0,
                           sum=float(m.sum()))
        np.save(os.path.join(out, f"{name}_{rank}.npy"), m)
    with open(os.path.join(out, f"stats_{rank}.json"), "w") as f:
        json.dump(stats, f)
    print(f"rank {rank} of {nproc} ({backend}, {devices}): "
          f"sums {stats['sharded']['sum']:.0f} / {stats['ring']['sum']:.0f}",
          flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
