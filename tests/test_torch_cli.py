"""`python -m compairr_tpu_torch` against `python -m compairr_tpu` on the
same synthetic files: the output files must be byte-equal. The device
routes, the dense engine (COMPAIRR_ENGINE=dense) and the tile route of
find_pairs, run on the CPU here through COMPAIRR_DEVICE=cpu."""

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
    # counts up to 200: min, max and Jaccard past the dense chains' 64
    big = d / "big"
    big.mkdir()
    a_big, b_big = write_pair(big, max_count=200)
    return {"a": a, "b": b, "q": q, "A": a_big, "B": b_big, "dir": d}


def _run(pkg, args, out, env_extra, stderr=None):
    """The output file's bytes; the run's standard error is appended to
    the list stderr when one is given."""
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
    if stderr is not None:
        stderr.append(proc.stderr)
    with open(out, "rb") as f:
        return f.read()


INPUTS = ("a", "b", "q", "A", "B")


def _compare(files, args, env_extra, tag):
    args = [files[a] if a in INPUTS else a for a in args]
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


# -d 1 -i takes dense_indel, -s min/max/Jaccard on counts above 64
# (files A and B) dense_general, -d 2 under COMPAIRR_V3=0 (DENSE_ENV)
# dense_onehot, the rest dense_match
DENSE = {
    "dense_d2": ["-m", "-d", "2", "a", "b"],
    "dense_d1_f": ["-m", "-d", "1", "-f", "a", "b"],
    "dense_d0_mh": ["-m", "-d", "0", "-s", "MH", "a", "b"],
    "dense_d2_g_mean": ["-m", "-d", "2", "-g", "-s", "mean", "a", "b"],
    "dense_d1_i": ["-m", "-d", "1", "-i", "a", "b"],
    "dense_d1_i_max": ["-m", "-d", "1", "-i", "-s", "max", "a", "b"],
    "dense_d2_min_big": ["-m", "-d", "2", "-s", "min", "A", "B"],
    # CompAIRR defines the Jaccard index at d 0 only
    "dense_d0_jaccard_big": ["-m", "-d", "0", "-s", "Jaccard", "A", "B"],
    "dense_d1_i_max_big": ["-m", "-d", "1", "-i", "-s", "max", "A", "B"],
    "dense_d2_v3_0": ["-m", "-d", "2", "a", "b"],
}
# the environment a DENSE run adds, for both packages
DENSE_ENV = {"dense_d2_v3_0": {"COMPAIRR_V3": "0"}}


# the sparse tile route of find_pairs, on the CPU (COMPAIRR_DEVICE=cpu):
# -d 1 -i takes it by default and -d 2 under COMPAIRR_PIGEONHOLE=0.
# tag -> (arguments, COMPAIRR_PIGEONHOLE of the port's run, of the JAX
# package's run). The JAX package's own tile route on the CPU compiles
# XLA scans for about 30 s a run, so all but the first indel run take
# its host indel route (COMPAIRR_PIGEONHOLE=all), which its tests hold
# to its tile route.
TILES = {
    "tiles_m_d1_i": (["-m", "-d", "1", "-i", "a", "b"], None, None),
    "tiles_x_d1_i": (["-x", "-d", "1", "-i", "q", "b"], None, "all"),
    "tiles_c_d1_i": (["-c", "-d", "1", "-i", "b"], None, "all"),
    "tiles_m_d1_i_pairs": (
        ["-m", "-d", "1", "-i", "-p", "pairs", "--distance", "a", "b"],
        None, "all",
    ),
    "tiles_m_d2_ph0": (["-m", "-d", "2", "a", "b"], "0", "0"),
}


@pytest.mark.parametrize("tag", list(TILES))
def test_cli_tile_route_byte_equal(files, tag):
    args, port_ph, jax_ph = TILES[tag]

    def side(pkg, ph, suffix, env, stderr=None):
        if ph is not None:
            env = dict(env, COMPAIRR_PIGEONHOLE=ph)
        pairs = files["dir"] / f"{tag}.{suffix}.pairs"
        argv = [
            str(pairs) if a == "pairs" else files.get(a, a) for a in args
        ]
        out = _run(pkg, argv, files["dir"] / f"{tag}.{suffix}", env, stderr)
        return out, pairs.read_bytes() if "pairs" in args else None

    stderr = []
    got = side("compairr_tpu_torch", port_ph, "torch", {
        "COMPAIRR_DEVICE": "cpu", "COMPAIRR_TIMING": "1",
    }, stderr)
    want = side("compairr_tpu", jax_ph, "jax", {})
    assert got == want
    assert want[0].count(b"\n") > 1
    if want[1] is not None:
        assert want[1].count(b"\n") > 1
    # the port resolved the run on the tile route, whose phase timing
    # (COMPAIRR_TIMING=1) reports its worklist tiles
    assert "[timing] find_pairs tiles=" in stderr[0]


@pytest.mark.parametrize("tag", list(DENSE))
def test_cli_dense_engine_byte_equal(files, tag):
    out = _compare(
        files, DENSE[tag],
        {"COMPAIRR_ENGINE": "dense", "COMPAIRR_DEVICE": "cpu",
         **DENSE_ENV.get(tag, {})}, tag,
    )
    # and equal to the port's own host route (the host indel route for
    # -i, whose default route is the tile route on the card)
    host = _run(
        "compairr_tpu_torch",
        [files[a] if a in INPUTS else a for a in DENSE[tag]],
        files["dir"] / f"{tag}.host",
        {"COMPAIRR_PIGEONHOLE": "all"} if "-i" in DENSE[tag] else {},
    )
    assert out == host
