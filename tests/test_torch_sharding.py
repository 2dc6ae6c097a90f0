"""The port's multi-device layer (compairr_tpu_torch/parallel/mesh.py, the
tile route's device split in ops/engine.py and the CLI above them) on
the CPU, where devices=[cpu] * n stands in for n devices, against the
JAX package's (compairr_tpu/parallel/mesh.py on jax.devices()[:n], the
8 virtual CPU devices of tests/conftest.py) and against the port's own
single-device paths. Integer matrices are compared exactly (rtol 0,
atol 0); ratio sums are float64, added in another order on each shard:
rtol 1e-12 against the port's single device, 1e-5 against JAX's
float32 sums. Pair sets and CLI bytes are compared exactly."""

import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from compairr_tpu.constants import (
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)
from compairr_tpu.ops import engine as jeng
from compairr_tpu.parallel import mesh as jmesh
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.parallel import mesh as tmesh
from compairr_tpu_torch.utils import device as D

from synth import make_tsv
from torch_port_data import read_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """tests/test_sharding.py's sets: 600 x 450 rows, lengths 6..9."""
    d = tmp_path_factory.mktemp("tshard")
    shape = dict(alphabet_sub=3, max_count=3, len_range=(6, 9))
    a = make_tsv(str(d / "a.tsv"), 600, 5, seed=31, **shape)
    b = make_tsv(str(d / "b.tsv"), 450, 7, seed=32, **shape)
    return read_pair(a, b)


def _specs(d, indels, **kw):
    return (jeng.MatchSpec(differences=d, indels=indels, ignore_genes=False,
                           **kw),
            teng.MatchSpec(differences=d, indels=indels, ignore_genes=False,
                           **kw))


def _with_counts(pair, scale):
    from dataclasses import replace

    return tuple(replace(x, counts=x.counts * scale) for x in pair)


# case: (d, indels, score, -f, counts scale, COMPAIRR_V3, the port's kernel)
CASES = {
    "indel": (1, True, SCORE_PRODUCT, False, 1, "1", "dense_indel"),
    "match": (2, False, SCORE_PRODUCT, False, 1, "1", "dense_match"),
    "onehot": (2, False, SCORE_PRODUCT, False, 1, "0", "dense_onehot"),
    "mean": (1, False, SCORE_MEAN, False, 1, "1", "dense_match"),
    "f": (2, False, SCORE_MH, True, 1, "1", "dense_match"),
    "general_min": (2, False, SCORE_MIN, False, 40, "1", "dense_general"),
    "general_indel": (1, True, SCORE_MIN, False, 40, "1", "dense_general"),
}


@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_and_single(dbs, monkeypatch, case, ndev):
    d, indels, score, f, scale, v3, kind = CASES[case]
    (d1, d2), (t1, t2) = dbs
    if scale != 1:
        d1, d2 = _with_counts((d1, d2), scale)
        t1, t2 = _with_counts((t1, t2), scale)
    jspec, tspec = _specs(d, indels)
    monkeypatch.setenv("COMPAIRR_V3", v3)
    assert teng.dense_plan(t1, t2, tspec, score, f).kind == kind
    want = jmesh.dense_matrix_sharded(d1, d2, jspec, score, f,
                                      devices=jax.devices()[:ndev])
    single = teng.dense_matrix(t1, t2, tspec, score, f, device="cpu")
    got = tmesh.dense_matrix_sharded(t1, t2, tspec, score, f,
                                     devices=[CPU] * ndev)
    stats = dict(tmesh.LAST_STATS)
    ring = tmesh.dense_matrix_ring(t1, t2, tspec, score, f,
                                   devices=[CPU] * ndev)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got, single, rtol=0, atol=0)
    np.testing.assert_allclose(ring, single, rtol=0, atol=0)
    assert want.sum() > 0
    assert stats["devices"] == ndev and stats["backend"] == "none"
    assert len(stats["real_tiles"]) == ndev
    assert stats["padded_tiles_per_shard"] == max(stats["real_tiles"])


def test_sharded_self_comparison(dbs):
    (d1, _), (t1, _) = dbs
    jspec, tspec = _specs(2, False)
    want = jmesh.dense_matrix_sharded(d1, d1, jspec, SCORE_PRODUCT, True,
                                      devices=jax.devices()[:8])
    single = teng.dense_matrix(t1, t1, tspec, SCORE_PRODUCT, True,
                               device="cpu")
    got = tmesh.dense_matrix_sharded(t1, t1, tspec, SCORE_PRODUCT, True,
                                     devices=[CPU] * 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got, single, rtol=0, atol=0)


def test_sharded_ratio(dbs):
    """Ratio sums are float64 on every shard: rtol 1e-12 of one device's
    float64 and 1e-5 of JAX's float32 sums."""
    (d1, d2), (t1, t2) = dbs
    jspec, tspec = _specs(2, False)
    want = jmesh.dense_matrix_sharded(d1, d2, jspec, SCORE_RATIO, False,
                                      devices=jax.devices()[:8])
    single = teng.dense_matrix(t1, t2, tspec, SCORE_RATIO, False,
                               device="cpu")
    for fn in (tmesh.dense_matrix_sharded, tmesh.dense_matrix_ring):
        got = fn(t1, t2, tspec, SCORE_RATIO, False, devices=[CPU] * 8)
        np.testing.assert_allclose(got, single, rtol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert single.sum() > 0


def test_side_span_equals_the_span_derived_alone(dbs, monkeypatch):
    """engine.side_span cuts a span out of a set's derived rows, padded
    with its pad row: every tensor equals the one derived from the span's
    rows alone, for each kernel's layout."""
    from dataclasses import replace

    (_, _), (t1, t2) = dbs
    kinds = set()
    for d, indels, score, v3, scale in ((2, False, SCORE_PRODUCT, "1", 1),
                                        (2, False, SCORE_PRODUCT, "0", 1),
                                        (1, True, SCORE_PRODUCT, "1", 1),
                                        (1, True, SCORE_MIN, "1", 40)):
        monkeypatch.setenv("COMPAIRR_V3", v3)
        a, b = _with_counts((t1, t2), scale)
        _, spec = _specs(d, indels)
        plan = teng.dense_plan(a, b, spec, score, False, 128, 128)
        whole = teng.dense_side(plan, a, plan.order_a, plan.key_a,
                                plan.npad_a, CPU)
        assert teng.side_span(whole, 0, a.n, 1024, CPU) is whole
        kinds.add(plan.kind)
        for lo, hi in ((0, 200), (130, 457), (457, a.n), (a.n, a.n)):
            npad = teng._round_up(hi - lo, 128) + 128
            got = teng.side_span(whole, lo, hi, npad, CPU)
            idx = plan.order_a[lo:hi]
            alone = replace(a, **{f: getattr(a, f)[idx] for f in
                                  ("seqs", "lengths", "counts", "rep_no",
                                   "v_no", "j_no")},
                            sequence_ids=[None] * (hi - lo),
                            keep=[None] * (hi - lo), row_hash=None)
            key = np.full(npad, teng._KEY_PAD, dtype=np.int64)
            key[: hi - lo] = plan.key_a[lo:hi]
            want = teng.dense_side(plan, alone,
                                   np.arange(hi - lo, dtype=np.int32), key,
                                   npad, CPU)
            assert got.n == hi - lo
            np.testing.assert_array_equal(got.key, want.key)
            assert sorted(got.rows) == sorted(want.rows)
            for k, t in want.rows.items():
                assert torch.equal(got.rows[k], t), (plan.kind, lo, hi, k)
    assert kinds == {"dense_match", "dense_onehot", "dense_indel",
                     "dense_general"}


def test_default_shards_follow_the_worklist(dbs, monkeypatch):
    """Without a device list, dense_matrix_sharded takes rank_devices()
    but no more shards than the worklist gives DENSE_TILES_PER_SHARD_MIN
    tiles each, one at least; a given list is taken whole. The matrix is
    the same either way."""
    (_, _), (t1, t2) = dbs
    _, spec = _specs(1, False)
    single = teng.dense_matrix(t1, t2, spec, SCORE_PRODUCT, False,
                               device="cpu")
    tiles = len(teng.dense_plan(t1, t2, spec, SCORE_PRODUCT, False).work)
    assert tiles >= 4
    monkeypatch.setattr(tmesh, "rank_devices", lambda *_: [CPU] * 4)
    for per_shard, shards in ((tiles + 1, 1), (tiles // 2, 2), (1, 4)):
        monkeypatch.setattr(tmesh, "DENSE_TILES_PER_SHARD_MIN", per_shard)
        got = tmesh.dense_matrix_sharded(t1, t2, spec, SCORE_PRODUCT, False)
        assert tmesh.LAST_STATS["devices"] == shards
        np.testing.assert_allclose(got, single, rtol=0, atol=0)
    monkeypatch.setattr(tmesh, "DENSE_TILES_PER_SHARD_MIN", tiles + 1)
    tmesh.dense_matrix_sharded(t1, t2, spec, SCORE_PRODUCT, False,
                               devices=[CPU] * 3)
    assert tmesh.LAST_STATS["devices"] == 3


def test_local_ranks_from_host_names(monkeypatch):
    """Ranks that joined without LOCAL_RANK and LOCAL_WORLD_SIZE (the
    tcp:// form of COMPAIRR_DISTRIBUTED) take them from the ranks that
    give their host's name in the rendezvous store; values already set
    stay."""
    import socket

    import torch.distributed as dist

    def fresh():
        for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.setenv(k, "x")
            monkeypatch.delenv(k)

    here = socket.gethostname()
    for hosts, rank, want in (([here, here, "elsewhere"], 1, ("1", "2")),
                              (["elsewhere", here], 1, ("0", "1"))):
        fresh()
        store = dist.HashStore()
        for r, h in enumerate(hosts):
            if r != rank:
                store.set(f"compairr_host/{r}", h)
        tmesh._local_ranks(store, rank, len(hosts))
        assert (os.environ["LOCAL_RANK"],
                os.environ["LOCAL_WORLD_SIZE"]) == want
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    tmesh._local_ranks(dist.HashStore(), 0, 1)
    assert (os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"]) == (
        "3", "4")


@pytest.mark.parametrize("fn", ["sharded", "ring"])
def test_dense_multidevice_rejects_exclude_self(dbs, fn):
    (_, _), (t1, _) = dbs
    _, spec = _specs(1, False, exclude_self=True)
    run = getattr(tmesh, f"dense_matrix_{fn}")
    with pytest.raises(ValueError, match="exclude_self"):
        run(t1, t1, spec, SCORE_PRODUCT, False, devices=[CPU] * 2)


@pytest.fixture(scope="module")
def ring_dbs(tmp_path_factory):
    """tests/test_sharding.py's ring sets: 300 x 400 rows."""
    d = tmp_path_factory.mktemp("tring")
    a = make_tsv(str(d / "a.tsv"), 300, 5, seed=71, alphabet_sub=5,
                 max_count=3)
    b = make_tsv(str(d / "b.tsv"), 400, 6, seed=72, alphabet_sub=5,
                 max_count=3)
    return read_pair(a, b)


@pytest.mark.parametrize("d,indels,self_cmp", [(1, True, False),
                                               (2, False, False),
                                               (1, False, True)],
                         ids=["d1_indel", "d2", "self_d1"])
def test_ring_matches_jax_and_single(ring_dbs, d, indels, self_cmp):
    """dense_matrix_ring (both sets sharded, set 2 handed round the ring)
    equals JAX's ring and the port's sharded and one-device matrices."""
    (d1, d2), (t1, t2) = ring_dbs
    if self_cmp:
        d2, t2 = d1, t1
    jspec, tspec = _specs(d, indels)
    want = jmesh.dense_matrix_ring(d1, d2, jspec, SCORE_PRODUCT, False)
    single = teng.dense_matrix(t1, t2, tspec, SCORE_PRODUCT, False,
                               device="cpu")
    ring = tmesh.dense_matrix_ring(t1, t2, tspec, SCORE_PRODUCT, False,
                                   devices=[CPU] * len(jax.devices()))
    repl = tmesh.dense_matrix_sharded(t1, t2, tspec, SCORE_PRODUCT, False,
                                      devices=[CPU] * len(jax.devices()))
    np.testing.assert_allclose(ring, want, rtol=0, atol=0)
    np.testing.assert_allclose(ring, single, rtol=0, atol=0)
    np.testing.assert_allclose(repl, single, rtol=0, atol=0)
    if self_cmp:
        assert single.sum() > 0


def _pairs_set(res):
    i1, i2, dist = res
    return set(zip(i1.tolist(), i2.tolist(), dist.tolist()))


@pytest.mark.parametrize(
    "dd,indels,exclude_self",
    [(1, False, False), (2, False, False), (1, True, False),
     (1, False, True), (1, True, True)],
)
def test_find_pairs_multidevice(dbs, monkeypatch, dd, indels, exclude_self):
    """The tile route returns the same pair set on 1 and 8 devices, equal
    to the JAX package's host routes' (COMPAIRR_PIGEONHOLE=all); on 8
    devices each class stream is counted in device spans."""
    from compairr_tpu_torch.ops import kernels as K

    (d1, d2), (t1, t2) = dbs
    da, db_ = (d1, d1) if exclude_self else (d1, d2)
    ta, tb = (t1, t1) if exclude_self else (t1, t2)
    jspec, tspec = _specs(dd, indels, exclude_self=exclude_self)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    want = _pairs_set(jeng.find_pairs(da, db_, jspec))
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    monkeypatch.setattr(teng, "TILES_PER_DEVICE_MIN", 1)

    calls = []
    count_tiles = K.count_tiles

    def counted(a, b, work, **kw):
        calls.append(len(work))
        return count_tiles(a, b, work, **kw)

    monkeypatch.setattr(K, "count_tiles", counted)
    single = teng.find_pairs(ta, tb, tspec, devices=[CPU])
    streams = len(calls)
    multi = teng.find_pairs(ta, tb, tspec, devices=[CPU] * 8)
    assert teng.LAST_ROUTE == "tiles"
    assert len(want) > 0
    assert _pairs_set(single) == want
    assert _pairs_set(multi) == want
    assert 1 <= streams <= 3 and len(calls) - streams > streams
    assert sum(calls[streams:]) == sum(calls[:streams])


@pytest.mark.parametrize("engine", ["tiles", "dense"])
def test_cli_multidevice_byte_identical(tmp_path, monkeypatch, engine):
    """A CLI -m -d 1 -i run (the tile route, with a pairs file; or the
    dense engine's sharded path) writes the same bytes on 1 and 8
    devices."""
    from compairr_tpu_torch.cli import main

    shape = dict(alphabet_sub=3, max_count=3, len_range=(6, 9))
    a = make_tsv(str(tmp_path / "a.tsv"), 500, 4, seed=81, **shape)
    b = make_tsv(str(tmp_path / "b.tsv"), 400, 5, seed=82, **shape)
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    monkeypatch.setattr(teng, "TILES_PER_DEVICE_MIN", 1)
    monkeypatch.setattr(tmesh, "DENSE_TILES_PER_SHARD_MIN", 1)
    if engine == "dense":
        monkeypatch.setenv("COMPAIRR_ENGINE", "dense")
    outs = {}
    for ndev in (1, 8):
        monkeypatch.setattr(D, "local_devices",
                            lambda device=None, n=ndev: [CPU] * n)
        out = tmp_path / f"out{ndev}.tsv"
        pairs = tmp_path / f"pairs{ndev}.tsv"
        args = ["-m", a, b, "-d", "1", "-i", "-o", str(out),
                "-l", str(tmp_path / f"log{ndev}.txt")]
        if engine == "tiles":
            args += ["-p", str(pairs)]
        tmesh.LAST_STATS.clear()
        assert main(args) == 0
        if engine == "dense":  # as many shards as the worklist fills
            shards = tmesh.LAST_STATS.get("devices")
            assert (shards is None if ndev == 1 else 1 < shards <= ndev)
        outs[ndev] = (out.read_bytes(),
                      pairs.read_bytes() if engine == "tiles" else b"")
    assert outs[1] == outs[8]
    assert outs[1][0].count(b"\n") > 1
    if engine == "tiles":
        assert len(outs[1][1].splitlines()) > 1


@pytest.fixture
def native_parser(tmp_path, monkeypatch):
    """The native parser built into tmp_path and loaded from there
    (COMPAIRR_INPUT_SHARD reads line-aligned byte chunks through it);
    the repository's native/ directory is left as it is."""
    from compairr_tpu_torch.io import native

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    src = tmp_path / "native"
    shutil.copytree(os.path.join(REPO, "native"), src)
    subprocess.run(["make", "-C", str(src), "CXXFLAGS=-O1 -fPIC -std=c++17"],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: str(src / "libairr_parser.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.load_library() is not None


def test_input_shard_merge(tmp_path, monkeypatch, native_parser):
    """COMPAIRR_INPUT_SHARD=k/n runs, each reading the k-th chunk of set
    1, merge by repertoire pair into the whole run's matrix."""
    from compairr_tpu_torch.cli import main

    a = make_tsv(str(tmp_path / "a.tsv"), 400, 4, seed=91,
                 alphabet_sub=3, len_range=(6, 9))
    b = make_tsv(str(tmp_path / "b.tsv"), 300, 5, seed=92,
                 alphabet_sub=3, len_range=(6, 9))

    def threecol(path):
        out = {}
        with open(path) as f:
            assert f.readline().startswith("#")
            for line in f:
                r1, r2, v = line.rstrip("\n").split("\t")
                out[(r1, r2)] = out.get((r1, r2), 0.0) + float(v)
        return out

    full = tmp_path / "full.tsv"
    monkeypatch.delenv("COMPAIRR_INPUT_SHARD", raising=False)
    assert main(["-m", "-d", "1", "-a", a, b, "-o", str(full),
                 "-l", str(tmp_path / "l0.txt")]) == 0
    want = threecol(full)
    merged = {}
    hosts = 3
    for k in range(hosts):
        monkeypatch.setenv("COMPAIRR_INPUT_SHARD", f"{k}/{hosts}")
        part = tmp_path / f"part{k}.tsv"
        assert main(["-m", "-d", "1", "-a", a, b, "-o", str(part),
                     "-l", str(tmp_path / f"l{k + 1}.txt")]) == 0
        for key, v in threecol(part).items():
            merged[key] = merged.get(key, 0.0) + v
    assert any(want.values()), "fixture produced no matches"
    for key in set(want) | set(merged):
        assert merged.get(key, 0.0) == want.get(key, 0.0), key


def test_balanced_bounds_even_tiles(dbs, monkeypatch):
    """Tile-balanced shard bounds (mesh._balanced_bounds): below 4 blocks
    a shard they fall back to equal row spans; on a big set they cut the
    sorted rows contiguously on block boundaries, as JAX's do, with
    per-shard tile counts no less even than equal spans'; both layouts
    give the same matrix."""
    import bench
    from chip_smoke import synth_arrays

    (_, _), (t1, t2) = dbs
    _, spec = _specs(1, False)
    m_bal = tmesh.dense_matrix_sharded(t1, t2, spec, SCORE_PRODUCT, False,
                                       devices=[CPU] * 4)
    monkeypatch.setenv("COMPAIRR_SHARD_BALANCE", "0")
    m_eq = tmesh.dense_matrix_sharded(t1, t2, spec, SCORE_PRODUCT, False,
                                      devices=[CPU] * 4)
    np.testing.assert_allclose(m_bal, m_eq, rtol=0, atol=0)

    # 600 rows at tile 256: 3 blocks < 4 * 4
    plan = teng.dense_plan(t1, t2, spec, SCORE_PRODUCT, False, 256, 256)
    assert (tmesh._balanced_bounds(plan, t1.n, 4)
            == tmesh._equal_span_bounds(t1.n, 4))

    # the JAX package's benchmark generator and the port's copy of it:
    # the same rows, with a realistic spread of CDR3 lengths
    big = synth_arrays(40_000, n_reps=8, n_v=12, n_j=5, seed=7)
    plan = teng.dense_plan(big, big, spec, SCORE_PRODUCT, False, 256, 256)
    bounds = tmesh._balanced_bounds(plan, big.n, 4)
    jbig = bench.synth_arrays(40_000, n_reps=8, n_v=12, n_j=5, seed=7)
    ja = jeng.pack_set(jbig, int(jbig.longest), 256, True)
    jspec, _ = _specs(1, False)
    assert bounds == jmesh._balanced_bounds(ja, ja, jspec, 256, 256, 4)
    assert bounds[0][0] == 0 and bounds[-1][1] == big.n
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
    assert all(lo % 256 == 0 for lo, _ in bounds)

    def tiles(bds):
        return [len(teng.worklist_from_keys(plan.key_a[lo:hi], hi - lo,
                                            plan.key_b, big.n, 0, 256, 256))
                for lo, hi in bds]

    assert max(tiles(bounds)) <= max(
        tiles(tmesh._equal_span_bounds(big.n, 4)))
    assert sum(tiles(bounds)) == len(plan.work)


def test_device_lists(monkeypatch):
    """local_devices: [cpu] on the CPU, every CUDA device capped by
    COMPAIRR_DEVICES, one named device; rank_devices shares a host's
    devices between its ranks; choose_backend takes gloo on the CPU and
    where ranks share a card, nccl where each has its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ("LOCAL_WORLD_SIZE", "MASTER_ADDR", "COMPAIRR_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert D.local_devices("cpu") == [CPU]
    assert D.local_devices("cuda") == cuda
    assert D.local_devices("cuda:2") == [torch.device("cuda", 2)]
    monkeypatch.setenv("COMPAIRR_DEVICES", "2")
    assert D.local_devices("cuda") == cuda[:2]
    monkeypatch.delenv("COMPAIRR_DEVICES")
    assert tmesh.rank_devices("cuda") == cuda
    assert tmesh.choose_backend("cuda") == "nccl"
    assert tmesh.choose_backend("cpu") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh.rank_devices("cuda") == cuda[2:]
    assert tmesh.choose_backend("cuda") == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.rank_devices("cuda") == [torch.device("cuda", 0)]
    assert tmesh.choose_backend("cuda") == "gloo"
    assert tmesh.initialize_distributed() is None  # no group asked for
