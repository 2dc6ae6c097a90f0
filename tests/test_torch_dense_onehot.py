"""The port's dense runs under COMPAIRR_V3=0, which JAX sends to its v2
kernel (pallas_kernels._make_dense_v2_kernel) and the port to
dense_onehot (csrc/dense_onehot.cu, an int8 one-hot product), on the CPU:

  * engine.dense_matrix(device="cpu") against the JAX package's
    dense_matrix through v2 (Pallas interpret mode), in every score
    mode v2 serves at counts <= 64, with and without -g, and on
    single-bucket data;
  * dense_onehot_plain (the CPU side of the wrapper, the one-hot
    formulation step by step) against dense_match_plain on the same
    derived rows and worklists, in every score mode, at lpad 24 and 48,
    on tiles of 64 and 128 rows and on tiles whose rows and columns
    differ, over worklists that cover every pad row, on rows in key
    order and shuffled;
  * the kernel choice: COMPAIRR_V3 moves only dense_match's runs.

Every sum is an integer (mean: half-integer), so equality is exact.
"""

import numpy as np
import pytest
import torch

from compairr_tpu.constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MH,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)
from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.core.db import GeneTables, SeqDB
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from synth import make_tsv
from torch_port_data import read_pair, write_pair


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("dense_onehot")))


@pytest.fixture
def v3_off(monkeypatch):
    monkeypatch.setenv("COMPAIRR_V3", "0")


@pytest.fixture
def kinds(monkeypatch):
    """The port's dense kernels and plain versions that dense_matrix
    called, by name."""
    called = []
    for name in ("dense_match", "dense_onehot", "dense_indel",
                 "dense_general", "dense_onehot_plain"):
        real = getattr(K, name)

        def spy(*a, _real=real, _name=name, **k):
            called.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(K, name, spy)
    return called


@pytest.fixture
def v2_calls(monkeypatch):
    calls = []
    real = P._dense_v2_fn

    def probe(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(P, "_dense_v2_fn", probe)
    return calls


def _specs(d, genes):
    return (
        jeng.MatchSpec(differences=d, indels=False, ignore_genes=genes),
        teng.MatchSpec(differences=d, indels=False, ignore_genes=genes),
    )


MODES = [
    (SCORE_PRODUCT, False),
    (SCORE_MEAN, False),
    (SCORE_MH, False),
    (SCORE_PRODUCT, True),  # -f
    (SCORE_MIN, False),  # counts <= 3: within v2's min chains
    (SCORE_MAX, False),
]
MODE_IDS = ["product", "mean", "MH", "f", "min", "max"]


def _held_to_v2(d1, d2, t1, t2, jspec, tspec, score, f, kinds, v2_calls):
    P.LAST_DENSE_KERNEL = None
    want = jeng.dense_matrix(d1, d2, jspec, score, f, engine="pallas")
    assert v2_calls and P.LAST_DENSE_KERNEL == "v2"
    got = teng.dense_matrix(t1, t2, tspec, score, f, device="cpu")
    assert kinds == ["dense_onehot", "dense_onehot_plain"]
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("genes", [False, True], ids=["vj", "g"])
@pytest.mark.parametrize("score,f", MODES, ids=MODE_IDS)
def test_dense_onehot_matches_jax_v2(dbs, v3_off, kinds, v2_calls, genes,
                                     score, f):
    (d1, d2), (t1, t2) = dbs
    _held_to_v2(d1, d2, t1, t2, *_specs(2, genes), score, f, kinds,
                v2_calls)


@pytest.mark.parametrize("genes", [False, True], ids=["vj", "g"])
def test_dense_onehot_single_bucket_matches_jax_v2(tmp_path, v3_off, kinds,
                                                   v2_calls, genes):
    """One V, one J and one length (tests/test_dense.py:754's shape):
    every tile is one key run, the case the one-hot product is for."""
    shape = dict(n_v=1, n_j=1, len_range=(10, 10), alphabet_sub=4,
                 max_count=3)
    a = make_tsv(str(tmp_path / "a.tsv"), 300, 4, seed=41, **shape)
    b = make_tsv(str(tmp_path / "b.tsv"), 260, 5, seed=42, **shape)
    (d1, d2), (t1, t2) = read_pair(a, b)
    _held_to_v2(d1, d2, t1, t2, *_specs(2, genes), SCORE_PRODUCT, False,
                kinds, v2_calls)


@pytest.mark.parametrize("tile", [64, 256])
def test_dense_onehot_self_comparison(dbs, v3_off, kinds, tile):
    """A self-comparison shares one derive, so every pad row meets
    every pad row (equal keys -1, all-pad residues, every position a
    match) and only rep -1 keeps them out; at tile 256 whole all-pad
    tiles lie inside the worklist's range."""
    (d1, _), (t1, _) = dbs
    jspec, tspec = _specs(1, False)
    want = jeng.dense_matrix(d1, d1, jspec, SCORE_MH, False, engine="xla")
    got = teng.dense_matrix(t1, t1, tspec, SCORE_MH, False, tile_m=tile,
                            tile_n=tile, device="cpu")
    assert kinds == ["dense_onehot", "dense_onehot_plain"]
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def _planted_db(n, lpad, rng, reps, src=None, frac=0.4):
    """A SeqDB of n rows whose lengths pad to lpad (amino acids at 24,
    nucleotides at 48), 2 V and 2 J genes, counts 1..63; with src, about
    frac of its rows are src rows with 0 to 3 substitutions."""
    nt = lpad > 32
    alpha = 4 if nt else 20
    pad = alpha if nt else 20
    lengths = rng.integers(lpad - 7, lpad, n).astype(np.int32)
    seqs = np.full((n, lpad - 1), pad, dtype=np.int8)
    mask = np.arange(lpad - 1)[None, :] < lengths[:, None]
    seqs[mask] = rng.integers(0, alpha, int(mask.sum()), dtype=np.int8)
    v_no = rng.integers(0, 2, n).astype(np.int32)
    j_no = rng.integers(0, 2, n).astype(np.int32)
    if src is not None:
        k = int(n * frac)
        dst = rng.choice(n, k, replace=False)
        take = rng.choice(src.n, k, replace=False)
        seqs[dst] = src.seqs[take]
        lengths[dst] = src.lengths[take]
        v_no[dst] = src.v_no[take]
        j_no[dst] = src.j_no[take]
        for t in dst:
            pos = rng.choice(lengths[t], int(rng.integers(0, 4)),
                             replace=False)
            seqs[t, pos] = (seqs[t, pos] + rng.integers(1, alpha, len(pos))) \
                % alpha
    genes = GeneTables()
    for name in ("V0", "V1"):
        genes.intern_v(name)
    for name in ("J0", "J1"):
        genes.intern_j(name)
    return SeqDB(
        nucleotides=nt, seqs=seqs, lengths=lengths,
        counts=rng.integers(1, 64, n).astype(np.int64),
        rep_no=rng.integers(0, reps, n).astype(np.int32), v_no=v_no,
        j_no=j_no, sequence_ids=[None] * n, keep=[None] * n,
        repertoire_ids=[f"R{r}" for r in range(reps)], genes=genes,
        residues_count=int(lengths.sum()), total_dup_count=n,
        shortest=int(lengths.min()), longest=int(lengths.max()),
    )


def _rows(db, tile):
    order, key, npad = teng.pack_keys(db, tile, True)
    lpad = teng._round_up(int(db.longest), 8)
    return K.device_args_raw(db, order, npad, lpad, key, "cpu"), key


@pytest.fixture(scope="module", params=[24, 48], ids=["lpad24", "lpad48"])
def planted(request):
    rng = np.random.default_rng(request.param)
    d1 = _planted_db(300, request.param, rng, 5)
    return d1, _planted_db(350, request.param, rng, 7, src=d1)


SC_MODES = [K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX, K.SC_SUM]
SC_IDS = ["one", "product", "min", "max", "sum"]


def _shuffled(side, seed):
    """The rows of a device_args_raw dict in a random order (pads no
    longer last, every tile's keys mixed): the wrapper takes rows in
    any order."""
    perm = torch.from_numpy(
        np.random.default_rng(seed).permutation(side["rep"].shape[0]))
    return dict(side, **{k: side[k][perm].contiguous()
                         for k in ("seqs", "key32", "rep", "cnt")})


def _plain_pair_check(planted, tiles, mode, shuffle):
    d1, d2 = planted
    tm, tn = tiles
    a, ka = _rows(d1, tm)
    b, kb = _rows(d2, tn)
    if shuffle:
        a, b = _shuffled(a, 1), _shuffled(b, 2)
    assert a["seqs"].shape[1] in (24, 48)
    na, nb = a["seqs"].shape[0], b["seqs"].shape[0]
    assert na > d1.n and nb > d2.n
    keyed = teng.order_colmajor(
        teng.worklist_from_keys(ka, d1.n, kb, d2.n, 0, tm, tn))
    every = np.array([(r, c) for r in range(0, na - tm + 1, tm)
                      for c in range(0, nb - tn + 1, tn)], dtype=np.int32)
    for work in (keyed, every):
        kw = dict(differences=2, score_mode=mode, tile_m=tm, tile_n=tn,
                  r1p=8, r2p=128)
        w = K.upload_worklist(work, "cpu")
        before = dict(K.LAUNCHES)
        got = K.dense_onehot(a, b, w, **kw)
        assert K.LAUNCHES == before  # the plain version is no launch
        want = K.dense_match_plain(a, b, w, **kw)
        assert got.dtype == torch.int64 and got.shape == (8, 128)
        assert torch.equal(got, want)
        assert int(want.sum()) > 0


TILES = pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (64, 128)],
                                ids=["t64", "t128", "t64x128"])


@TILES
@pytest.mark.parametrize("mode", SC_MODES, ids=SC_IDS)
def test_dense_onehot_plain_equals_dense_match_plain(planted, tiles, mode):
    """The two plain versions on the worklist from the keys (its last
    row and column blocks hold real rows and pad rows) and on every
    tile pair of both padded row sets (all-pad tiles included)."""
    _plain_pair_check(planted, tiles, mode, shuffle=False)


@TILES
@pytest.mark.parametrize("mode", SC_MODES, ids=SC_IDS)
def test_dense_onehot_plain_shuffled_equals_dense_match_plain(planted, tiles,
                                                              mode):
    """The same on rows in a random order (pads no longer last, every
    tile's keys mixed): the wrapper takes rows in any order."""
    _plain_pair_check(planted, tiles, mode, shuffle=True)


def test_onehot_rows_layout():
    """Feature (c, p) at lane c * lpad + p, zero lanes up to K."""
    seqs = torch.tensor([[0, 20, 3, 3], [19, 1, 20, 20]], dtype=torch.int8)
    oh = K.onehot_rows(seqs)
    assert oh.dtype == torch.int8 and oh.shape == (2, K.onehot_width(4))
    assert K.onehot_width(4) == 96 and K.onehot_width(24) == 512
    assert K.onehot_width(48) == 1024
    for r in range(2):
        lanes = sorted(oh[r].nonzero().squeeze(1).tolist())
        assert lanes == sorted(int(c) * 4 + p
                               for p, c in enumerate(seqs[r].tolist()))
    # the product of two rows counts their equal positions
    assert int((oh[0].long() * oh[1].long()).sum()) == 0
    assert int((oh[0].long() * oh[0].long()).sum()) == 4


@pytest.mark.parametrize("bad", ["tile", "ratio", "key_dtype", "code",
                                 "outside", "rep_dtype", "rep_shape"])
def test_dense_onehot_rejects_bad_inputs(planted, bad):
    d1, d2 = planted
    a, ka = _rows(d1, 64)
    b, kb = _rows(d2, 64)
    w = K.upload_worklist(
        teng.worklist_from_keys(ka, d1.n, kb, d2.n, 0, 64, 64), "cpu")
    kw = dict(differences=2, score_mode=K.SC_PRODUCT, tile_m=64, tile_n=64,
              r1p=8, r2p=128)
    error = ValueError
    if bad == "tile":
        kw.update(tile_m=32, tile_n=32)
    elif bad == "ratio":
        kw.update(score_mode=K.SC_RATIO)
    elif bad == "key_dtype":
        b = dict(b, key32=b["key32"].to(torch.int64))
    elif bad == "rep_dtype":
        # the kernel reads rep beside key32 (its key ranges, the cells)
        b = dict(b, rep=b["rep"].to(torch.int64))
    elif bad == "rep_shape":
        b = dict(b, rep=b["rep"][:-1])
    elif bad == "code":
        # a residue code past the 21 one-hot classes: the device check
        seqs = b["seqs"].clone()
        seqs[0, 0] = 21
        b, error = dict(b, seqs=seqs), RuntimeError
    else:
        w = K.upload_worklist(np.array([[0, b["seqs"].shape[0]]]), "cpu")
        error = RuntimeError
    with pytest.raises(error):
        K.dense_onehot(a, b, w, **kw)


def test_dense_kind_boundaries_with_v3(monkeypatch):
    """COMPAIRR_V3 moves dense_match's runs only: unset or "1" gives
    dense_match, "0" dense_onehot; -d 1 -i keeps dense_indel and the
    runs of dense_general keep theirs (ratio, counts >= 2^16, a min
    count past 64, keys >= 2^31)."""
    kind = K._dense_kernel_kind
    base = dict(indels=False, score_int=SCORE_PRODUCT, ignore_counts=False,
                cmax=3, key_max=(1 << 31) - 1)
    monkeypatch.delenv("COMPAIRR_V3", raising=False)
    assert kind(**base) == "dense_match"
    monkeypatch.setenv("COMPAIRR_V3", "1")
    assert kind(**base) == "dense_match"
    monkeypatch.setenv("COMPAIRR_V3", "0")
    assert kind(**base) == "dense_onehot"
    assert kind(**dict(base, score_int=SCORE_JACCARD, cmax=64)) \
        == "dense_onehot"
    assert kind(**dict(base, ignore_counts=True, cmax=1 << 20)) \
        == "dense_onehot"
    assert kind(**dict(base, indels=True)) == "dense_indel"
    for other in (dict(score_int=SCORE_RATIO), dict(cmax=1 << 16),
                  dict(score_int=SCORE_MIN, cmax=65),
                  dict(key_max=1 << 31)):
        assert kind(**dict(base, **other)) == "dense_general"
        assert kind(**dict(base, indels=True, **other)) == "dense_general"

