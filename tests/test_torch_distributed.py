"""Two processes of the port on torch.distributed (gloo on the CPU, 4
local shards each, so 8 global shards): each rank's dense_matrix_sharded
(cross-rank all_reduce) and dense_matrix_ring (cross-rank hand-offs by
batch_isend_irecv) must equal, exactly (rtol 0, atol 0), the JAX
package's single-device dense_matrix on __graft_entry__._dryrun_dbs,
whose matrix sums to 238 (MULTICHIP_r05.json)."""

import numpy as np


def test_two_process_distributed_matches_jax_single():
    from __graft_entry__ import _dryrun_dbs
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops.engine import dense_matrix
    from compairr_tpu_torch.graft_entry import _dryrun_dbs as port_dbs
    from compairr_tpu_torch.parallel.worker import launch

    d1, d2, spec = _dryrun_dbs()
    single = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False)
    assert single.sum() == 238
    # the port's copy of the sets holds the same rows
    for jdb, tdb in zip((d1, d2), port_dbs()[:2]):
        for k in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no"):
            np.testing.assert_array_equal(getattr(tdb, k), getattr(jdb, k))

    results = launch(nproc=2, local_devices=4, device="cpu")
    assert set(results) == {0, 1}
    for sharded, ring in results.values():
        np.testing.assert_allclose(sharded, single, rtol=0, atol=0)
        np.testing.assert_allclose(ring, single, rtol=0, atol=0)


def _cli_ranks_match_single(tmp_path, rank_env):
    """Two CLI processes (-m -d 1 -i on the dense engine, on the CPU),
    each with rank_env(r) added to its environment, must both join one
    gloo group and each write the bytes of a single-process run."""
    import os
    import subprocess
    import sys

    from synth import make_tsv

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shape = dict(alphabet_sub=3, max_count=3, len_range=(6, 9))
    a = make_tsv(str(tmp_path / "a.tsv"), 500, 4, seed=81, **shape)
    b = make_tsv(str(tmp_path / "b.tsv"), 400, 5, seed=82, **shape)
    env = dict(os.environ, COMPAIRR_ENGINE="dense", COMPAIRR_DEVICE="cpu")
    for k in ("COMPAIRR_DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)

    def cli(out, **extra):
        return subprocess.Popen(
            [sys.executable, "-m", "compairr_tpu_torch", "-m", "-d", "1",
             "-i", a, b, "-o", str(out), "-l", str(out) + ".log"],
            cwd=repo, env=dict(env, **extra), stderr=subprocess.PIPE,
            text=True,
        )

    procs = [cli(tmp_path / f"out{r}.tsv", **rank_env(r)) for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    assert all("backend gloo" in e for e in errs), errs
    single = cli(tmp_path / "single.tsv")
    single.communicate(timeout=300)
    assert single.returncode == 0
    want = (tmp_path / "single.tsv").read_bytes()
    assert want.count(b"\n") > 1
    for r in (0, 1):
        assert (tmp_path / f"out{r}.tsv").read_bytes() == want


def test_cli_distributed_dense_matches_single(tmp_path):
    """Two CLI processes under COMPAIRR_DISTRIBUTED (a tcp:// rendezvous,
    WORLD_SIZE 2, RANK 0 and 1; gloo on the CPU) take the dense engine's
    sharded path over both ranks, and each writes the bytes of a
    single-process run."""
    from compairr_tpu_torch.parallel.worker import _free_port

    url = f"tcp://localhost:{_free_port()}"
    _cli_ranks_match_single(tmp_path, lambda r: dict(
        COMPAIRR_DISTRIBUTED=url, WORLD_SIZE="2", RANK=str(r)))


def test_cli_joins_under_torchrun_env_alone(tmp_path):
    """torchrun's variables alone (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK; no COMPAIRR_DISTRIBUTED) make the CLI join the process group,
    as the JAX package's CLI joins under its launcher's variable."""
    from compairr_tpu_torch.parallel.worker import _free_port

    port = str(_free_port())
    _cli_ranks_match_single(tmp_path, lambda r: dict(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
        RANK=str(r)))


def test_ranks_with_unequal_shard_counts_raise():
    """Every rank works out the global shard layout from its own count of
    local shards: ranks whose counts differ (here 2 and 3) each raise
    before a shard runs, and the launcher fails."""
    import pytest

    from compairr_tpu_torch.parallel.worker import launch

    with pytest.raises(RuntimeError, match="different numbers of local"):
        launch(nproc=2, local_devices=[2, 3], device="cpu")


def test_launch_runs_on_the_card_by_default(monkeypatch):
    """Like every device route, the launcher runs its ranks on CUDA unless
    asked for the CPU; without a card it raises before starting a rank."""
    import pytest
    import torch

    from compairr_tpu_torch.parallel import worker

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(worker.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        worker.launch(nproc=2, local_devices=1)
    assert not started
