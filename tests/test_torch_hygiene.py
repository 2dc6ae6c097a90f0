"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package (compairr_tpu), importing it leaves jax unloaded, host-only
routes never load torch, and a device route with no CUDA device and
no CPU request raises instead of running on the CPU."""

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


def test_dense_cli_without_cuda_fails(tmp_path):
    """The CLI's dense engine with no CUDA and no COMPAIRR_DEVICE
    request exits non-zero (this host's torch has no CUDA device)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b = write_pair(tmp_path)
    env = dict(os.environ, COMPAIRR_ENGINE="dense")
    env.pop("COMPAIRR_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "compairr_tpu_torch", "-m", "-d", "1", a, b,
         "-o", str(tmp_path / "o.tsv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "COMPAIRR_DEVICE=cpu" in proc.stderr
