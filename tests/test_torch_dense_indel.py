"""The port's dense runs with one indel (-d 1 -i), which JAX sends to its
v2c kernel (pallas_kernels._make_dense_v2c_kernel) and the port to
dense_indel (csrc/dense_general.cu), on the CPU:

  * engine.dense_matrix(device="cpu") against the JAX package's
    dense_matrix through v2c (Pallas interpret mode) and through its XLA
    scan path, in every score mode v2c serves, with and without -g;
  * dense_indel_plain (the CPU side of the wrapper) against the JAX
    package's v2c kernel on the same derived rows and worklist;
  * the derive with indels (reversed rows) against the JAX derive;
  * pads: a worklist over every tile pair, all-pad tiles included,
    against the host route's pairs, and self-comparisons at npad > n.

Every sum is an integer (mean: half-integer), so equality is exact.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from compairr_tpu.constants import (
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
)
from compairr_tpu.core.score import pair_scores
from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair

TILE = 128


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("dense_indel")))


def _specs(genes):
    return (
        jeng.MatchSpec(differences=1, indels=True, ignore_genes=genes),
        teng.MatchSpec(differences=1, indels=True, ignore_genes=genes),
    )


@pytest.fixture
def kinds(monkeypatch):
    """The port's kernels that dense_matrix called, by name."""
    called = []
    for name in ("dense_match", "dense_indel", "dense_general"):
        real = getattr(K, name)

        def spy(*a, _real=real, _name=name, **k):
            called.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(K, name, spy)
    return called


MODES = [
    (SCORE_PRODUCT, False),
    (SCORE_MH, False),
    (SCORE_MEAN, False),
    (SCORE_MIN, False),  # counts <= 3: within v2c's min chains
    (SCORE_PRODUCT, True),  # -f
]
MODE_IDS = ["product", "MH", "mean", "min", "f"]


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("genes", [False, True], ids=["vj", "g"])
@pytest.mark.parametrize("score,f", MODES, ids=MODE_IDS)
def test_dense_indel_matches_jax(dbs, kinds, engine, genes, score, f):
    (d1, d2), (t1, t2) = dbs
    jspec, tspec = _specs(genes)
    P.LAST_DENSE_KERNEL = None
    want = jeng.dense_matrix(d1, d2, jspec, score, f, engine=engine)
    if engine == "pallas":
        assert P.LAST_DENSE_KERNEL == "v2c"
    got = teng.dense_matrix(t1, t2, tspec, score, f, device="cpu")
    assert kinds == ["dense_indel"]
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("tile", [64, 256])
def test_dense_indel_self_comparison(dbs, kinds, tile):
    """A self-comparison shares one derive, so every pad row meets
    every pad row (equal keys -1, all-pad residues: a Hamming match
    that only rep -1 keeps out) and, at tile 256 (npad 640 for 400
    rows), whole all-pad tiles lie inside the worklist's range."""
    (d1, _), (t1, _) = dbs
    jspec, tspec = _specs(False)
    want = jeng.dense_matrix(d1, d1, jspec, SCORE_PRODUCT, False,
                             engine="xla")
    got = teng.dense_matrix(t1, t1, tspec, SCORE_PRODUCT, False,
                            tile_m=tile, tile_n=tile, device="cpu")
    assert kinds == ["dense_indel"]
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def _rows(jdb, tdb, tile=TILE, by_vjl=True):
    """(jax rows, port rows, sorted key, npad) of one set, with indels."""
    lpad = jeng._round_up(int(jdb.longest), 8)
    order, key, npad = jeng.pack_keys(jdb, tile, by_vjl)
    jrows = P.device_args_raw(jdb, order, npad, lpad, indels=True,
                              sort_key=key)["a"]
    t_order, t_key, t_npad = teng.pack_keys(tdb, tile, by_vjl)
    assert t_npad == npad
    np.testing.assert_array_equal(t_key, key)
    trows = K.device_args_raw(tdb, t_order, t_npad, lpad, t_key, "cpu",
                              indels=True)
    return jrows, trows, key, npad


@pytest.mark.parametrize("side", [0, 1])
def test_device_args_raw_indels_matches_jax(dbs, side):
    (j1, j2), (t1, t2) = dbs
    jdb, tdb = (j1, t1) if side == 0 else (j2, t2)
    jr, tr, key, npad = _rows(jdb, tdb)
    n = jdb.n
    for k in ("seqs", "rseqs"):
        assert tr[k].dtype == torch.int8 and tr[k].shape == (npad, 16)
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
    np.testing.assert_array_equal(tr["key32"].numpy(),
                                  np.asarray(jr["key32"]).ravel())
    np.testing.assert_array_equal(tr["rep"].numpy(),
                                  np.asarray(jr["rep"]).ravel())
    np.testing.assert_array_equal(tr["cnt"].numpy(),
                                  np.asarray(jr["cnt"]).ravel())
    # pads: key -1, rep -1, count 0, all-pad rows both ways
    assert (tr["key32"].numpy()[n:] == -1).all()
    assert (tr["rep"].numpy()[n:] == -1).all()
    assert (tr["cnt"].numpy()[n:] == 0).all()
    assert (tr["rseqs"].numpy()[n:] == tdb.pad_value).all()
    # without indels no reversed rows are derived
    order, _, _ = teng.pack_keys(tdb, TILE, True)
    assert "rseqs" not in K.device_args_raw(tdb, order, npad, 16, key, "cpu")


@pytest.fixture(scope="module")
def rows(dbs):
    """Both packages' derived rows with indels, and the delta-1
    worklist."""
    (d1, d2), _ = dbs
    ja, ta, ka, _ = _rows(d1, dbs[1][0])
    jb, tb, kb, _ = _rows(d2, dbs[1][1])
    work = jeng.worklist_from_keys(ka, d1.n, kb, d2.n, 1, TILE, TILE)
    r1p = jeng._round_up(d1.repertoire_count, 8)
    r2p = jeng._round_up(d2.repertoire_count, 128)
    return ja, jb, ta, tb, work, r1p, r2p


@pytest.mark.parametrize("score,f", MODES, ids=MODE_IDS)
def test_dense_indel_plain_matches_jax_v2c(rows, score, f, monkeypatch):
    ja, jb, ta, tb, work, r1p, r2p = rows
    calls = []
    real = P._dense_v2c_fn

    def probe(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(P, "_dense_v2c_fn", probe)
    want = np.asarray(
        P.dense_matrix_pallas(
            ja, jb, work, differences=1, indels=True, ignore_genes=False,
            score_int=score, ignore_counts=f, tile_m=TILE, tile_n=TILE,
            r1p=r1p, r2p=r2p, interpret=True,
        ),
        dtype=np.float64,
    )
    assert calls and P.LAST_DENSE_KERNEL == "v2c"
    before = dict(K.LAUNCHES)
    got = K.dense_indel(
        ta, tb, K.upload_worklist(teng.order_colmajor(work), "cpu"),
        differences=1, score_mode=K.score_mode(score, f), tile_m=TILE,
        tile_n=TILE, r1p=r1p, r2p=r2p,
    )
    assert K.LAUNCHES == before  # the plain version is no launch
    assert got.dtype == torch.int64 and got.shape == (r1p, r2p)
    # JAX's mean halves each pair on the device, the port once at the end
    scale = 2.0 if (score == SCORE_MEAN and not f) else 1.0
    np.testing.assert_array_equal(got.numpy(), want * scale)
    assert want.sum() > 0


def test_dense_indel_pads_never_contribute(dbs, rows, monkeypatch):
    """A worklist of every tile pair of both padded row sets (all-pad
    tiles and the pad tail of each set against everything) gives the
    matrix of the host route's pairs: no pad, whose key-derived length
    is garbage, ever passes the indel test or contributes."""
    (d1, d2), _ = dbs
    _, _, ta, tb, _, r1p, r2p = rows
    na, nb = ta["seqs"].shape[0], tb["seqs"].shape[0]
    assert na > d1.n and nb > d2.n
    every = np.array([(r, c) for r in range(0, na, TILE)
                      for c in range(0, nb, TILE)], dtype=np.int32)
    got = K.dense_indel(
        ta, tb, K.upload_worklist(every, "cpu"), differences=1,
        score_mode=K.SC_PRODUCT, tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p,
    ).numpy()[: d1.repertoire_count, : d2.repertoire_count]
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")  # host indel route
    i1, i2, _ = jeng.find_pairs(d1, d2, _specs(False)[0])
    want = np.zeros((d1.repertoire_count, d2.repertoire_count))
    np.add.at(want, (d1.rep_no[i1], d2.rep_no[i2]),
              pair_scores(d1.counts[i1], d2.counts[i2], SCORE_PRODUCT,
                          False))
    np.testing.assert_array_equal(got, want)
    assert len(i1) and (d1.lengths[i1] != d2.lengths[i2]).any()


@pytest.mark.parametrize("bad", ["no_rseqs", "key_dtype", "ratio",
                                 "outside"])
def test_dense_indel_rejects_bad_inputs(rows, bad):
    _, _, ta, tb, work, r1p, r2p = rows
    ta, tb = dict(ta), dict(tb)
    w = K.upload_worklist(work, "cpu")
    mode, error = K.SC_PRODUCT, ValueError
    if bad == "no_rseqs":
        del ta["rseqs"]
    elif bad == "key_dtype":
        tb["key32"] = tb["key32"].to(torch.int64)
    elif bad == "ratio":
        mode = K.SC_RATIO
    else:
        # a tile past the end of set 2: the device-side check
        w = K.upload_worklist(np.array([[0, tb["seqs"].shape[0]]]), "cpu")
        error = RuntimeError
    with pytest.raises(error):
        K.dense_indel(ta, tb, w, differences=1, score_mode=mode,
                      tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p)


def test_dense_indel_kind_boundaries():
    """The kernel choice for indel runs: dense_indel while keys fit
    int32 and the score has chains at counts below 2^16; dense_general
    otherwise."""
    kind = K._dense_kernel_kind
    base = dict(indels=True, ignore_counts=False, key_max=(1 << 31) - 1)
    assert kind(score_int=SCORE_MIN, cmax=64, **base) == "dense_indel"
    assert kind(score_int=SCORE_MIN, cmax=65, **base) == "dense_general"
    assert kind(score_int=SCORE_PRODUCT, cmax=(1 << 16) - 1,
                **base) == "dense_indel"
    assert kind(score_int=SCORE_PRODUCT, cmax=1 << 16,
                **base) == "dense_general"
    assert kind(score_int=SCORE_PRODUCT, cmax=3,
                **dict(base, key_max=1 << 31)) == "dense_general"
    assert kind(score_int=SCORE_PRODUCT, cmax=1 << 20,
                **dict(base, ignore_counts=True)) == "dense_indel"
    assert kind(score_int=SCORE_PRODUCT, cmax=3,
                **dict(base, indels=False)) == "dense_match"


def test_big_v_rows_take_wide_keys(dbs):
    """Rows narrow keys cannot hold raise in the derive."""
    (_, _), (t1, _) = dbs
    big = replace(t1, v_no=t1.v_no + (1 << 15))
    order, key, npad = teng.pack_keys(big, TILE, True)
    with pytest.raises(ValueError, match="must be wide"):
        K.device_args_raw(big, order, npad, 16, key, "cpu")
