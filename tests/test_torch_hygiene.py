"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package (compairr_tpu), importing it leaves jax unloaded, host-only
routes never load torch, and a device route (the dense engine, the
tile route of find_pairs) with no CUDA device and no CPU request
raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_data import write_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "compairr_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "compairr_tpu"}


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def _python(code, **env_extra):
    env = dict(os.environ)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_unloaded():
    mods = [
        "compairr_tpu_torch", "compairr_tpu_torch.cli",
        "compairr_tpu_torch.ops.engine", "compairr_tpu_torch.ops.kernels",
        "compairr_tpu_torch.modes.overlap", "compairr_tpu_torch.modes.dedup",
        "compairr_tpu_torch.modes.cluster",
        "compairr_tpu_torch.utils.device",
        "compairr_tpu_torch.utils.trace",
        "compairr_tpu_torch.parallel.mesh",
        "compairr_tpu_torch.parallel.worker",
        "compairr_tpu_torch.graft_entry",
        "compairr_tpu_torch.bench",
        "compairr_tpu_torch.scripts.weak_scaling",
        "compairr_tpu_torch.scripts.scale_demo",
        "compairr_tpu_torch.scripts.multihost_demo",
        "compairr_tpu_torch.scripts.ab_compare",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'compairr_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = _python(code)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_host_route_never_loads_torch(tmp_path):
    """-m -d 1 resolves on the host (pigeonhole) with no torch import."""
    a, b = write_pair(tmp_path)
    code = (
        "import sys\n"
        "from compairr_tpu_torch.cli import main\n"
        f"main(['-m', '-d', '1', {a!r}, {b!r}, '-o', "
        f"{str(tmp_path / 'o.tsv')!r}])\n"
        "assert 'torch' not in sys.modules\n"
        "print('hostonly')\n"
    )
    proc = _python(code)
    assert proc.returncode == 0 and "hostonly" in proc.stdout, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    import torch

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_route_without_cuda_raises(no_cuda):
    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.core.db import GeneTables, SeqDB
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix
    from compairr_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="COMPAIRR_DEVICE=cpu"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    db = SeqDB(
        nucleotides=False,
        seqs=np.zeros((2, 4), np.int8), lengths=np.full(2, 4, np.int32),
        counts=np.ones(2, np.int64), rep_no=np.zeros(2, np.int32),
        v_no=np.zeros(2, np.int32), j_no=np.zeros(2, np.int32),
        sequence_ids=[None, None], keep=[None, None],
        repertoire_ids=["R0"], genes=GeneTables(), longest=4,
    )
    spec = MatchSpec(differences=1, indels=False, ignore_genes=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dense_matrix(db, db, spec, SCORE_PRODUCT, False)
    m = dense_matrix(db, db, spec, SCORE_PRODUCT, False, device="cpu")
    assert m.tolist() == [[4.0]]


@pytest.mark.parametrize("indels,score,v3", [(True, "product", "1"),
                                             (False, "ratio", "1"),
                                             (False, "product", "0")],
                         ids=["dense_indel", "dense_general", "dense_onehot"])
def test_dense_kernels_without_cuda_raise(no_cuda, monkeypatch, indels,
                                          score, v3):
    """The dense runs that take dense_indel (-d 1 -i), dense_general
    (ratio) and dense_onehot (COMPAIRR_V3=0) raise the device message
    with no CUDA and no CPU request, and run when the CPU is asked
    for."""
    from compairr_tpu_torch.constants import SCORE_PRODUCT, SCORE_RATIO
    from compairr_tpu_torch.core.db import GeneTables, SeqDB
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix

    db = SeqDB(
        nucleotides=False,
        seqs=np.array([[0, 1, 2, 20], [0, 1, 2, 3]], np.int8),
        lengths=np.array([3, 4], np.int32), counts=np.array([2, 3]),
        rep_no=np.zeros(2, np.int32), v_no=np.zeros(2, np.int32),
        j_no=np.zeros(2, np.int32), sequence_ids=[None, None],
        keep=[None, None], repertoire_ids=["R0"], genes=GeneTables(),
        longest=4,
    )
    monkeypatch.setenv("COMPAIRR_V3", v3)
    spec = MatchSpec(differences=1, indels=indels, ignore_genes=False)
    score_int = SCORE_PRODUCT if score == "product" else SCORE_RATIO
    with pytest.raises(RuntimeError, match="COMPAIRR_DEVICE=cpu"):
        dense_matrix(db, db, spec, score_int, False)
    m = dense_matrix(db, db, spec, score_int, False, device="cpu")
    # with the indel both rows match each other: (2 + 3)^2; without it
    # each row matches itself only: ratio 2/2 + 3/3, product 2^2 + 3^2
    want = 25.0 if indels else (2.0 if score == "ratio" else 13.0)
    assert m.tolist() == [[want]]


def test_tile_route_without_cuda_raises(no_cuda):
    """find_pairs' tile route (-d 1 -i) raises the device message with
    no CUDA and no CPU request, and runs when the CPU is asked for."""
    from compairr_tpu_torch.core.db import GeneTables, SeqDB
    from compairr_tpu_torch.ops.engine import MatchSpec, find_pairs

    db = SeqDB(
        nucleotides=False,
        seqs=np.array([[0, 1, 2, 20], [0, 1, 2, 3]], np.int8),
        lengths=np.array([3, 4], np.int32), counts=np.ones(2, np.int64),
        rep_no=np.zeros(2, np.int32), v_no=np.zeros(2, np.int32),
        j_no=np.zeros(2, np.int32), sequence_ids=[None, None],
        keep=[None, None], repertoire_ids=["R0"], genes=GeneTables(),
        longest=4,
    )
    spec = MatchSpec(differences=1, indels=True, ignore_genes=False)
    with pytest.raises(RuntimeError, match="COMPAIRR_DEVICE=cpu"):
        find_pairs(db, db, spec)
    i1, i2, _ = find_pairs(db, db, spec, device="cpu")
    assert sorted(zip(i1.tolist(), i2.tolist())) == [
        (0, 0), (0, 1), (1, 0), (1, 1)
    ]


def _cli_without_cuda(tmp_path, flags, env_extra):
    a, b = write_pair(tmp_path)
    env = dict(os.environ, **env_extra)
    env.pop("COMPAIRR_DEVICE", None)
    return subprocess.run(
        [sys.executable, "-m", "compairr_tpu_torch", *flags, a, b,
         "-o", str(tmp_path / "o.tsv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )


def test_dense_cli_without_cuda_fails(tmp_path):
    """The CLI's dense engine with no CUDA and no COMPAIRR_DEVICE
    request exits non-zero (this host's torch has no CUDA device)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli_without_cuda(tmp_path, ["-m", "-d", "1"],
                             {"COMPAIRR_ENGINE": "dense"})
    assert proc.returncode != 0
    assert "COMPAIRR_DEVICE=cpu" in proc.stderr


def test_tile_cli_without_cuda_fails(tmp_path):
    """-m -d 1 -i takes the tile route by default: with no CUDA and no
    COMPAIRR_DEVICE request it exits non-zero with the device
    message."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli_without_cuda(tmp_path, ["-m", "-d", "1", "-i"], {})
    assert proc.returncode != 0
    assert "COMPAIRR_DEVICE=cpu" in proc.stderr
