"""The port's scripts (compairr_tpu_torch/scripts/) on the CPU: weak
scaling's checksums are exactly linear and equal to the JAX package's
dense_matrix_sharded of the same sets over its 8 CPU devices; the
Keck-scale generator writes the JAX script's bytes; the multi-host demo
merges per-host shards into one run's matrix; and the A/B harness, the
port's tree against itself, gives one checksum on both sides."""

import os
import re
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WS_ROWS = 3000


@pytest.fixture(scope="module")
def jax_weak_scaling():
    """JAX's sharded matrix sums of the weak-scaling sets over 1, 2 and 4
    of its CPU devices (its script's tile_db)."""
    import jax

    import bench as jbench
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops.engine import MatchSpec
    from compairr_tpu.parallel.mesh import dense_matrix_sharded
    from scripts.weak_scaling import tile_db

    base = jbench.synth_arrays(WS_ROWS, n_reps=12, n_v=16, n_j=6, seed=76)
    spec = MatchSpec(differences=1, indels=False, ignore_genes=False)
    return [float(dense_matrix_sharded(tile_db(base, k), base, spec,
                                       SCORE_PRODUCT, False,
                                       devices=jax.devices()[:k]).sum())
            for k in (1, 2, 4)]


@pytest.mark.parametrize("mode", ["sharded", "ring"])
def test_weak_scaling_linear_and_equal_to_jax(monkeypatch, jax_weak_scaling,
                                              mode):
    from compairr_tpu_torch.scripts import weak_scaling

    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    out = weak_scaling.main(["--per-device", str(WS_ROWS), "--devices", "4",
                             "--mode", mode])
    res = out["results"]
    assert [r["devices"] for r in res] == [1, 2, 4]
    assert [r["checksum"] for r in res] == jax_weak_scaling
    assert jax_weak_scaling[0] > 0
    # every shard on the one CPU device: no efficiency across devices,
    # the shared-device normalisation instead
    assert [r["efficiency"] for r in res] == [1.0, None, None]
    assert all(r["core_normalized"] is not None for r in res)
    if mode == "sharded":
        assert res[-1]["real_tiles"] and len(res[-1]["real_tiles"]) == 4
        assert res[-1]["compute_s"] > 0


def test_weak_scaling_tile_db_refuses_row_hash():
    from compairr_tpu_torch.bench import synth_arrays
    from compairr_tpu_torch.scripts.weak_scaling import tile_db

    base = synth_arrays(100, n_reps=2, n_v=2, n_j=2, seed=1)
    assert tile_db(base, 3).n == 300
    base.row_hash = np.zeros(100, dtype=np.uint64)
    with pytest.raises(ValueError, match="row_hash"):
        tile_db(base, 2)


def test_scale_demo_generator_and_cli(tmp_path, capsys):
    from compairr_tpu_torch.scripts import scale_demo
    from scripts.scale_demo import generate

    generate(str(tmp_path / "jax.tsv"), 1200, reps=6, seed=5)
    scale_demo.generate(str(tmp_path / "port.tsv"), 1200, reps=6, seed=5)
    assert ((tmp_path / "port.tsv").read_bytes()
            == (tmp_path / "jax.tsv").read_bytes())
    scale_demo.main(["1500", "--workdir", str(tmp_path / "w")])
    out = capsys.readouterr().out
    assert "rc=0" in out and "race skipped" in out
    assert (tmp_path / "w" / "ours.tsv").read_text().count("\n") > 1


def test_multihost_demo_two_hosts(tmp_path):
    """The demo's CLI processes read their input shards through the
    native parser, which a copy of the package and native/ under
    tmp_path is built with; the repository's native/ is left as it is."""
    import shutil
    import subprocess

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    shutil.copytree(os.path.join(REPO, "compairr_tpu_torch"),
                    tmp_path / "compairr_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(os.path.join(REPO, "native"), tmp_path / "native")
    subprocess.run(["make", "-C", str(tmp_path / "native"),
                    "CXXFLAGS=-O1 -fPIC -std=c++17"],
                   check=True, capture_output=True, timeout=300)
    proc = subprocess.run(
        [sys.executable, "-m", "compairr_tpu_torch.scripts.multihost_demo",
         "--hosts", "2", "--n", "3000"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "multihost_demo: OK: 2 sharded runs" in proc.stdout


@pytest.mark.parametrize("probe,env", [
    ("ab_probe_count.py", {"AB_N": "4000"}),
    ("ab_probe_dense.py", {"AB_NK": "3000", "AB_REPS": "1",
                           "AB_ROUNDS": "1"}),
])
def test_ab_compare_tree_against_itself(monkeypatch, capsys, probe, env):
    from compairr_tpu_torch.scripts import ab_compare

    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = os.path.join(REPO, "compairr_tpu_torch", "scripts", probe)
    assert ab_compare.main([REPO, REPO, "--rounds", "1", path]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ABRESULT" in ln]
    assert len(lines) == 2
    sums = {re.search(r"checksum=(\S+)", ln).group(1) for ln in lines}
    assert len(sums) == 1 and float(sums.pop()) > 0


def test_probes_run_against_the_named_tree(tmp_path):
    """A probe imports the package of the tree it is given: a tree
    without it fails, so no sample can come from the wrong tree."""
    import subprocess

    probe = os.path.join(REPO, "compairr_tpu_torch", "scripts",
                         "ab_probe_count.py")
    proc = subprocess.run(
        [sys.executable, probe, str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""), cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert "ABRESULT" not in proc.stdout
