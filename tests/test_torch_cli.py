"""`python -m compairr_tpu_torch` against `python -m compairr_tpu` on the
same synthetic files: the output files must be byte-equal. The dense
engine (COMPAIRR_ENGINE=dense) runs on the CPU here through
COMPAIRR_DEVICE=cpu, on both sides of the comparison."""

import os
import subprocess
import sys

import pytest

from synth import make_tsv
from torch_port_data import SHAPE, write_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    a, b = write_pair(d)
    # -x takes a single repertoire as its first set
    q = make_tsv(str(d / "q.tsv"), 60, 1, seed=23, **SHAPE)
    return {"a": a, "b": b, "q": q, "dir": d}


def _run(pkg, args, out, env_extra):
    env = dict(os.environ)
    # one JAX CPU device: the JAX package's multi-device dense path is
    # not what these tests compare
    env.pop("XLA_FLAGS", None)
    env.update(env_extra)
    proc = subprocess.run(
        [sys.executable, "-m", pkg, *args, "-o", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"{pkg} {args}: {proc.stderr[-2000:]}"
    with open(out, "rb") as f:
        return f.read()


def _compare(files, args, env_extra, tag):
    args = [files[a] if a in ("a", "b", "q") else a for a in args]
    want = _run("compairr_tpu", args, files["dir"] / f"{tag}.jax",
                env_extra)
    got = _run("compairr_tpu_torch", args, files["dir"] / f"{tag}.torch",
               env_extra)
    assert got == want
    assert want.count(b"\n") > 1
    return want


HOST = {
    "m_d0": ["-m", "-d", "0", "a", "b"],
    "m_d1": ["-m", "-d", "1", "a", "b"],
    "m_d2": ["-m", "-d", "2", "a", "b"],
    "m_d1_alt": ["-m", "-d", "1", "-a", "-s", "min", "a", "b"],
    "x_d1": ["-x", "-d", "1", "q", "b"],
    "c_d1": ["-c", "-d", "1", "b"],
    "z": ["-z", "b"],
}


@pytest.mark.parametrize("tag", list(HOST))
def test_cli_host_routes_byte_equal(files, tag):
    _compare(files, HOST[tag], {}, tag)


DENSE = {
    "dense_d2": ["-m", "-d", "2", "a", "b"],
    "dense_d1_f": ["-m", "-d", "1", "-f", "a", "b"],
    "dense_d0_mh": ["-m", "-d", "0", "-s", "MH", "a", "b"],
    "dense_d2_g_mean": ["-m", "-d", "2", "-g", "-s", "mean", "a", "b"],
}


@pytest.mark.parametrize("tag", list(DENSE))
def test_cli_dense_engine_byte_equal(files, tag):
    out = _compare(
        files, DENSE[tag],
        {"COMPAIRR_ENGINE": "dense", "COMPAIRR_DEVICE": "cpu"}, tag,
    )
    # and equal to the port's own host route
    host = _run(
        "compairr_tpu_torch",
        [files[a] if a in ("a", "b") else a for a in DENSE[tag]],
        files["dir"] / f"{tag}.host", {},
    )
    assert out == host
