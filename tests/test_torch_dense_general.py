"""The port's general dense runs, which JAX sends to its v1 kernel
(pallas_kernels._make_kernel) and the port to dense_general
(csrc/dense_general.cu), on the CPU: min, max and Jaccard with counts
above 64, product with counts >= 2^16, bucket keys >= 2^31 (32,768 or
more V x J combinations) and the ratio score, each at d 1, d 2 and d 1
with the indel.

  * engine.dense_matrix(device="cpu") against the JAX package's
    dense_matrix through v1 (Pallas interpret mode) and through its XLA
    scan path: integer modes exactly equal. Ratio sums floats: the port
    sums in float64 and is held within rtol 1e-12 of JAX's float64 host
    route (find_pairs, float64 scores), and within rtol 1e-5 of JAX's
    dense engines, which sum ratios in float32.
  * The int64/float64 rule: int64 sums while no cell can reach 2^62 by
    the per-block bounds, float64 beyond; both sides against the host
    route. Counts at and above 2^24, which JAX's dense derive rounds to
    float32, are held to JAX's host route instead of its dense engines.
  * dense_general_plain against the JAX v1 kernel on the same derived
    rows and worklist, and the wide derive (int64 key and count rows)
    against the JAX derive's len/v/j and count rows.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from compairr_tpu.constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)
from compairr_tpu.core.score import pair_scores
from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair

TILE = 128


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Counts 1..3."""
    return read_pair(*write_pair(tmp_path_factory.mktemp("general_small")))


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """Counts 1..200: above v2c's min/max chains."""
    return read_pair(
        *write_pair(tmp_path_factory.mktemp("general_big"), max_count=200)
    )


def _map(dbs, fn):
    (j1, j2), (t1, t2) = dbs
    return (fn(j1), fn(j2)), (fn(t1), fn(t2))


def _counts(value_fn):
    def f(db):
        return replace(db, counts=value_fn(db.counts.astype(np.int64)))
    return f


def _one_count_2_16(c):
    """Row 0's count raised to 2^16: enough for dense_general, and few
    enough big counts that JAX's exactness guard keeps most tiles on its
    v1 kernel (tiles it bounds at 2^24 or more go to its host path)."""
    c = c.copy()
    c[0] = 1 << 16
    return c


def _wide_keys(db):
    """Every V index raised by 2^15: 2^16 and more V x J combinations,
    bucket keys >= 2^32."""
    return replace(db, v_no=db.v_no + (1 << 15))


CASES = {
    "min_big": ("big", None, SCORE_MIN),
    "max_big": ("big", None, SCORE_MAX),
    "jaccard_big": ("big", None, SCORE_JACCARD),
    "product_2_16": ("big", _counts(_one_count_2_16), SCORE_PRODUCT),
    "keys_2_31": ("small", _wide_keys, SCORE_PRODUCT),
    "ratio": ("big", None, SCORE_RATIO),
}
SPECS = [(1, False), (2, False), (1, True)]
SPEC_IDS = ["d1", "d2", "d1_indel"]


def _data(request, case):
    which, fn, score = CASES[case]
    dbs = request.getfixturevalue(which)
    return (_map(dbs, fn) if fn else dbs), score


@pytest.fixture
def kinds(monkeypatch):
    """(kernel name, keyword arguments) of each port kernel call."""
    called = []
    for name in ("dense_match", "dense_indel", "dense_general"):
        real = getattr(K, name)

        def spy(*a, _real=real, _name=name, **k):
            called.append((_name, k))
            return _real(*a, **k)

        monkeypatch.setattr(K, name, spy)
    return called


def _jspec(d, indels):
    return jeng.MatchSpec(differences=d, indels=indels, ignore_genes=False)


def _tspec(d, indels):
    return teng.MatchSpec(differences=d, indels=indels, ignore_genes=False)


def host_matrix(d1, d2, spec, score, monkeypatch):
    """JAX's host route: find_pairs (the host indel route for indel
    runs) and float64 scores summed into the matrix."""
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    i1, i2, _ = jeng.find_pairs(d1, d2, spec)
    m = np.zeros((d1.repertoire_count, d2.repertoire_count))
    np.add.at(m, (d1.rep_no[i1], d2.rep_no[i2]),
              pair_scores(d1.counts[i1], d2.counts[i2], score, False))
    return m


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("d,indels", SPECS, ids=SPEC_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_dense_general_matches_jax(request, kinds, monkeypatch, case, d,
                                   indels, engine):
    ((j1, j2), (t1, t2)), score = _data(request, case)
    P.LAST_DENSE_KERNEL = None
    want = jeng.dense_matrix(j1, j2, _jspec(d, indels), score, False,
                             engine=engine)
    if engine == "pallas":
        assert P.LAST_DENSE_KERNEL == "v1"
    got = teng.dense_matrix(t1, t2, _tspec(d, indels), score, False,
                            device="cpu")
    assert [k for k, _ in kinds] == ["dense_general"]
    assert kinds[0][1]["indels"] == indels
    # ratio sums in float64; every other case here stays below 2^62
    assert kinds[0][1]["float_out"] == (score == SCORE_RATIO)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert want.sum() > 0
    if score != SCORE_RATIO:
        np.testing.assert_array_equal(got, want)
        return
    # JAX's dense engines sum ratios in float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    host = host_matrix(j1, j2, _jspec(d, indels), score, monkeypatch)
    np.testing.assert_allclose(got, host, rtol=1e-12)


def test_float64_sums_where_int64_could_overflow(big, kinds, monkeypatch):
    """Counts 2^32 x (1..200): products reach 2^79, past int64, so
    dense_general sums in float64. Every product is 2^64 times an
    integer below 2^16 and no cell sums 2^37 of them, so float64 holds
    each sum exactly: equal to JAX's host route. (JAX's dense engines
    send every tile of this run to their own float64 host path.)"""
    ((j1, j2), (t1, t2)) = _map(big, _counts(lambda c: c << 32))
    for d, indels in ((2, False), (1, True)):
        kinds.clear()
        got = teng.dense_matrix(t1, t2, _tspec(d, indels), SCORE_PRODUCT,
                                False, device="cpu")
        assert [(k, a["float_out"]) for k, a in kinds] == [
            ("dense_general", True)]
        want = host_matrix(j1, j2, _jspec(d, indels), SCORE_PRODUCT,
                           monkeypatch)
        np.testing.assert_array_equal(got, want)
        assert want.max() >= 2.0 ** 63


def test_int64_sums_at_counts_past_float32(big, kinds, monkeypatch):
    """Counts 2^24 + (1..200): JAX's dense derive rounds them to
    float32 (2^24 + 1 becomes 2^24), so its dense engines are no
    yardstick here; its host route is. The cells stay far below 2^62:
    int64 sums, exact, equal to the host route in min and max."""
    ((j1, j2), (t1, t2)) = _map(big, _counts(lambda c: c + (1 << 24)))
    for score in (SCORE_MIN, SCORE_MAX):
        kinds.clear()
        got = teng.dense_matrix(t1, t2, _tspec(2, False), score, False,
                                device="cpu")
        assert [(k, a["float_out"]) for k, a in kinds] == [
            ("dense_general", False)]
        want = host_matrix(j1, j2, _jspec(2, False), score, monkeypatch)
        np.testing.assert_array_equal(got, want)
        assert want.min() >= 1 << 24


def test_cell_bound_rule():
    """_cell_bound on a hand-built worklist: the per-block bounds of
    each score family, summed over the tiles."""
    stats_a = (np.array([2.0, 1.0]), np.array([10.0, 5.0]))  # (M, S)
    stats_b = (np.array([3.0]), np.array([7.0]))
    work = np.array([[0, 0], [4, 0]])  # row blocks 0 and 1 of tile 4
    bound = teng._cell_bound
    assert bound(work, stats_a, stats_b, 4, 4, SCORE_PRODUCT, True) == 9.0
    assert bound(work, stats_a, stats_b, 4, 4, SCORE_PRODUCT,
                 False) == 105.0
    # S_a M_b + S_b M_a: (30 + 14) + (15 + 7)
    assert bound(work, stats_a, stats_b, 4, 4, SCORE_MIN, False) == 66.0
    assert bound(work, stats_a, stats_b, 4, 4, SCORE_RATIO,
                 False) == float("inf")
    assert bound(work[:0], stats_a, stats_b, 4, 4, SCORE_PRODUCT,
                 False) == 0.0


def _rows(jdb, tdb, indels, tile=TILE):
    """(jax rows, port wide rows, sorted key, npad) of one set."""
    lpad = jeng._round_up(int(jdb.longest), 8)
    order, key, npad = jeng.pack_keys(jdb, tile, True)
    jrows = P.device_args_raw(jdb, order, npad, lpad, indels=indels,
                              sort_key=key)["a"]
    t_order, t_key, _ = teng.pack_keys(tdb, tile, True)
    trows = K.device_args_raw(tdb, t_order, npad, lpad, t_key, "cpu",
                              indels=indels, wide=True)
    return jrows, trows, key, npad


@pytest.mark.parametrize("wide_keys", [False, True], ids=["keys", "keys64"])
def test_device_args_raw_wide_matches_jax(big, wide_keys):
    (j1, _), (t1, _) = _map(big, _wide_keys) if wide_keys else big
    jr, tr, key, npad = _rows(j1, t1, True)
    n = j1.n
    assert (jr.get("key32") is None) == wide_keys
    for k in ("seqs", "rseqs"):
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    assert tr["key64"].dtype == torch.int64 and tr["cnt64"].dtype == torch.int64
    assert "key32" not in tr and "cnt" not in tr
    k64 = tr["key64"].numpy()
    np.testing.assert_array_equal(k64[:n], key[:n])
    assert (k64[n:] == -1).all()
    # the key row stands for JAX's len / v / j rows
    nj = len(j1.genes.j_names)
    np.testing.assert_array_equal(k64[:n] & 0xFFFF,
                                  np.asarray(jr["len"]).ravel()[:n])
    vj = np.asarray(jr["v"]).ravel()[:n].astype(np.int64) * nj + np.asarray(
        jr["j"]).ravel()[:n]
    np.testing.assert_array_equal(k64[:n] >> 16, vj)
    np.testing.assert_array_equal(tr["rep"].numpy(),
                                  np.asarray(jr["rep"]).ravel())
    np.testing.assert_array_equal(tr["cnt64"].numpy(),
                                  np.asarray(jr["cnt"]).ravel())
    assert int(tr["cnt64"].max()) > 64


@pytest.fixture(scope="module")
def rows(big):
    """Both packages' rows with indels (port: wide) and the delta-1
    worklist, on the counts-up-to-200 sets."""
    (d1, d2), (t1, t2) = big
    ja, ta, ka, _ = _rows(d1, t1, True)
    jb, tb, kb, _ = _rows(d2, t2, True)
    return ja, jb, ta, tb, (ka, kb), d1, d2


@pytest.mark.parametrize("indels", [False, True], ids=["d2", "d1_indel"])
@pytest.mark.parametrize("score", [SCORE_MIN, SCORE_MAX, SCORE_PRODUCT,
                                   SCORE_RATIO],
                         ids=["min", "max", "product", "ratio"])
def test_dense_general_plain_matches_jax_v1(rows, score, indels,
                                            monkeypatch):
    ja, jb, ta, tb, (ka, kb), d1, d2 = rows
    d = 1 if indels else 2
    work = jeng.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), TILE,
                                   TILE)
    r1p = jeng._round_up(d1.repertoire_count, 8)
    r2p = jeng._round_up(d2.repertoire_count, 128)
    calls = []
    real = P._dense_pallas_fn

    def probe(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(P, "_dense_pallas_fn", probe)
    want = np.asarray(
        P.dense_matrix_pallas(
            ja, jb, work, differences=d, indels=indels, ignore_genes=False,
            score_int=score, ignore_counts=False, tile_m=TILE, tile_n=TILE,
            r1p=r1p, r2p=r2p, interpret=True,
        ),
        dtype=np.float64,
    )
    # counts up to 200: no chains for min/max, so JAX runs v1
    if score != SCORE_PRODUCT:
        assert calls and P.LAST_DENSE_KERNEL == "v1"
    ratio = score == SCORE_RATIO
    before = dict(K.LAUNCHES)
    got = K.dense_general(
        ta, tb, K.upload_worklist(teng.order_colmajor(work), "cpu"),
        differences=d, indels=indels, score_mode=K.score_mode(score, False),
        float_out=ratio, tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p,
    )
    assert K.LAUNCHES == before  # the plain version is no launch
    assert got.dtype == (torch.float64 if ratio else torch.int64)
    assert got.shape == (r1p, r2p)
    if ratio:
        # JAX v1 sums ratios in float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    # float64 sums of the integer modes give the same matrix
    if not ratio:
        f64 = K.dense_general(
            ta, tb, K.upload_worklist(work, "cpu"), differences=d,
            indels=indels, score_mode=K.score_mode(score, False),
            float_out=True, tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p,
        )
        np.testing.assert_array_equal(f64.numpy(), want)


@pytest.mark.parametrize("bad", ["narrow_key", "ratio_int64", "no_rseqs"])
def test_dense_general_rejects_bad_inputs(rows, bad):
    _, _, ta, tb, (ka, kb), d1, d2 = rows
    ta = dict(ta)
    work = K.upload_worklist(
        jeng.worklist_from_keys(ka, d1.n, kb, d2.n, 1, TILE, TILE), "cpu"
    )
    mode, indels = K.SC_MIN, True
    if bad == "narrow_key":
        ta["key64"] = ta["key64"].to(torch.int32)
    elif bad == "ratio_int64":
        mode = K.SC_RATIO
    else:
        del ta["rseqs"]
    with pytest.raises(ValueError):
        K.dense_general(ta, tb, work, differences=1, indels=indels,
                        score_mode=mode, float_out=False, tile_m=TILE,
                        tile_n=TILE, r1p=8, r2p=128)
