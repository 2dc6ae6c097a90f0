"""The port's sparse tile route against the JAX package's, on the CPU.

  * the tile derive, kernels.device_rows_raw, against
    pallas_kernels.device_rows_raw: residue rows, reversed rows, the
    key row with its salted pad band, original indices;
  * count_tiles_plain and extract_tiles_plain (the plain versions of
    the port's CUDA kernels) against count_tiles_pallas and the JAX
    package's extraction, tile by tile and pair by pair (its packed
    match words decoded bit by bit);
  * engine.find_pairs(device="cpu") against the JAX package's
    find_pairs and a brute-force oracle: pair sets and distances.

Everything is integer, so every comparison is exact.
"""

from dataclasses import dataclass, replace

import numpy as np
import pytest
import torch

from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.core.db import seqdb_from_arrays
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K
from compairr_tpu_torch.ops import sparse_host as tsh

from test_oracle import hamming, make_db, oracle_pairs
from torch_port_data import read_pair, write_pair

TILE = 128


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("tiles")))


def _big_keys(db):
    """db with every V gene index raised by 2^13: its bucket keys
    ((v * nj + j) << 16 | length) are then >= 2^29, where the JAX
    package derives len/v/j rows and the port an int64 key row."""
    return replace(db, v_no=db.v_no + (1 << 13))


def _sides(dbs, big):
    (j1, j2), (t1, t2) = dbs
    if big:
        j1, j2, t1, t2 = map(_big_keys, (j1, j2, t1, t2))
    return (j1, j2), (t1, t2)


def _rows(jdb, tdb, indels, salt, tile=TILE, by_vjl=True):
    """(jax rows, port rows, sorted key, npad) of one set."""
    lpad = jeng._round_up(int(jdb.longest), 8)
    order, key, npad = jeng.pack_keys(jdb, tile, by_vjl)
    jrows, _ = P.device_rows_raw(
        jdb, order, npad, lpad, indels, sort_key=key, pad_salt=salt
    )
    t_order, t_key, t_npad = teng.pack_keys(tdb, tile, by_vjl)
    assert t_npad == npad
    np.testing.assert_array_equal(t_key, key)
    trows = K.device_rows_raw(
        tdb, t_order, t_npad, lpad, indels, t_key, salt, "cpu",
        wide=K.wide_keys(t_key[: tdb.n]),
    )
    return jrows, trows, key, npad


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("side,salt", [(0, 0), (1, 2)])
def test_device_rows_raw_matches_jax(dbs, side, salt, big):
    jdbs, tdbs = _sides(dbs, big)
    jdb, tdb = jdbs[side], tdbs[side]
    jr, tr, key, npad = _rows(jdb, tdb, True, salt)
    n = jdb.n
    assert tr["seqs"].dtype == torch.int8 and tr["seqs"].shape == (npad, 16)
    np.testing.assert_array_equal(tr["seqs"].numpy(), np.asarray(jr["seqs"]))
    np.testing.assert_array_equal(
        tr["rseqs"].numpy(), np.asarray(jr["rseqs"])
    )
    np.testing.assert_array_equal(
        tr["orig"].numpy(), np.asarray(jr["orig"]).ravel()
    )
    assert tr["orig"].dtype == torch.int32
    assert (tr["orig"].numpy()[n:] == -1).all()
    if big:
        # JAX's legacy rows: no key32, lengths/V/J rows instead
        assert jr.get("key32") is None
        assert tr["key"].dtype == torch.int64
        band = (1 << 62) + 2 + salt + 4 * np.arange(npad - n, dtype=np.int64)
        np.testing.assert_array_equal(
            tr["key"].numpy(), np.concatenate([key[:n], band])
        )
        np.testing.assert_array_equal(
            (tr["key"].numpy()[:n] & 0xFFFF),
            np.asarray(jr["len"]).ravel()[:n],
        )
    else:
        assert tr["key"].dtype == torch.int32
        np.testing.assert_array_equal(
            tr["key"].numpy(), np.asarray(jr["key32"]).ravel()
        )
    # without indels no reversed rows are derived
    order, _, _ = teng.pack_keys(tdb, TILE, True)
    no_rev = K.device_rows_raw(tdb, order, npad, 16, False, key, salt, "cpu",
                               wide=big)
    assert no_rev["rseqs"] is None
    if big:
        # narrow rows cannot hold these keys: the derive raises
        with pytest.raises(ValueError, match="must be wide"):
            K.device_rows_raw(tdb, order, npad, 16, False, key, salt, "cpu",
                              wide=False)


def test_pad_band_never_matches(dbs):
    """Pad keys sit at key distance >= 2 from every key of either set
    (so no pad is a Hamming or an indel candidate), save a pad's own
    twin in a self-comparison."""
    (j1, j2), (t1, t2) = dbs
    _, ra, _, _ = _rows(j1, t1, False, 0)
    _, rb, _, _ = _rows(j2, t2, False, 2)
    ka = ra["key"].numpy().astype(np.int64)
    kb = rb["key"].numpy().astype(np.int64)
    pads_a, pads_b = ka[t1.n :], kb[t2.n :]
    assert len(np.unique(pads_a)) == len(pads_a)
    for pads, other in ((pads_a, kb), (pads_b, ka), (pads_a, ka[: t1.n])):
        d = np.abs(pads[:, None] - other[None, :])
        assert d.min() >= 2


def _work(key_a, na, key_b, nb, delta, order, stream, tile=TILE):
    work = jeng.worklist_from_keys(key_a, na, key_b, nb, delta, tile, tile)
    if stream == "indel_only":
        has_eq, has_pm = jeng.classify_worklist(
            work, key_a, na, key_b, nb, tile, tile
        )
        work = work[~has_eq & has_pm]
        assert len(work)
    return jeng.order_colmajor(work) if order == "colmajor" else work


# d, indels, exclude_self, self-comparison, worklist stream
KERNEL_CASES = [
    (0, False, False, False, "all"),
    (1, False, False, False, "all"),
    (1, True, False, False, "all"),
    (1, True, True, True, "all"),
    (1, True, False, False, "indel_only"),
    (2, False, True, False, "all"),
    (2, False, True, True, "all"),
]


@pytest.mark.parametrize("order", ["colmajor", "raw"])
@pytest.mark.parametrize("d,indels,xself,self_cmp,stream", KERNEL_CASES)
def test_count_tiles_plain_matches_pallas(dbs, d, indels, xself, self_cmp,
                                          stream, order):
    c = _Case(dbs, d, indels, xself, self_cmp, stream, order)
    want = c.count_pallas()
    got = K.count_tiles(c.ta, c.tb, c.work_t, **c.kw)
    assert got.dtype == torch.int32 and got.shape == (len(c.work),)
    np.testing.assert_array_equal(got.numpy(), want)
    if d >= 1:
        assert want.sum() > 0


class _Case:
    """One kernel case: both packages' rows, the worklist, and the
    port's keyword arguments."""

    def __init__(self, dbs, d, indels, xself, self_cmp, stream, order,
                 big=False):
        # indel-only tiles take 32-row tiles: at 128 this data has one
        # such tile, and it holds no match
        self.tile = tile = 32 if stream == "indel_only" else TILE
        (j1, j2), (t1, t2) = _sides(dbs, big)
        if self_cmp:
            j2, t2 = j1, t1
        self.jdbs = (j1, j2)
        self.d, self.xself = d, xself
        self.indels = indels and d == 1
        self.indel_only = stream == "indel_only"
        self.ja, self.ta, ka, _ = _rows(j1, t1, self.indels, 0, tile)
        if self_cmp:
            self.jb, self.tb, kb = self.ja, self.ta, ka
        else:
            self.jb, self.tb, kb, _ = _rows(j2, t2, self.indels, 2, tile)
        self.work = _work(ka, j1.n, kb, j2.n, int(self.indels), order,
                          stream, tile)
        self.cls = (
            K.CLS_INDEL_ONLY if self.indel_only
            else K.CLS_BOTH if self.indels else K.CLS_HAMMING
        )
        self.work_t = K.upload_worklist(self.work, "cpu")
        self.kw = dict(differences=d, cls=self.cls, exclude_self=xself,
                       tile_m=tile, tile_n=tile)

    def pallas_kw(self):
        return dict(differences=self.d, indels=self.indels,
                    ignore_genes=False, exclude_self=self.xself,
                    tile_m=self.tile, tile_n=self.tile, interpret=True,
                    indel_only=self.indel_only)

    def count_pallas(self):
        return np.asarray(P.count_tiles_pallas(
            self.ja, self.jb, self.work, **self.pallas_kw()
        )).ravel()

    def extract_pallas(self, k):
        idx, vals, n = P.extract_tiles_pallas(
            self.ja, self.jb, self.work, k=k, **self.pallas_kw()
        )
        n = int(n)
        return (np.asarray(idx)[:n],
                np.asarray(vals)[:n].astype(np.uint32), n)


def _xla_words(jdbs, lpad, tile, work, d, indels, indel_only, xself, k):
    """The JAX package's XLA extraction (its CPU route: the match mask
    of pack_set rows, packed with integer shifts) over the tiles of
    work: (word_idx, word_bits, count, original indices of a's rows and
    of b's)."""
    import jax.numpy as jnp

    rows = [jeng.pack_set(db, lpad, tile, True, need_rseqs=True)
            for db in jdbs]
    args = [(p.seqs, p.rseqs, p.lengths, p.v, p.j, p.orig) for p in rows]
    spec = jeng.MatchSpec(d, indels, False, xself)
    fn = jeng._extract_fn(spec, tile, tile, len(work), k, indels_ov=indels,
                          indel_only=indel_only)
    idx, vals, n = fn(*args[0], *args[1], jnp.asarray(work))
    n = int(n)
    return (np.asarray(idx)[:n], np.asarray(vals)[:n].astype(np.uint32), n,
            rows[0].orig, rows[1].orig)


# bits 15 and 31 of a word: the Pallas extract kernel packs words with
# f32 matmuls against weights jnp.exp2(bit), and XLA:CPU's exp2 is not
# exact at integers (exp2(15.0) = 32767.984...), so in interpret mode on
# the CPU those two bits come back as 0x7FFF / 0x7FFF0000 patterns
_INEXACT_BITS = np.uint32((1 << 15) | (1 << 31))


def _decode_words(idx, bits, work, a_orig, b_orig, tile):
    """Packed match words decoded bit by bit into their pairs of
    original indices: {tile: sorted [(a orig, b orig)]}."""
    wpr = tile // 32
    tiles: dict = {}
    for i, v in zip(idx.tolist(), bits.tolist()):
        t, rest = divmod(i, tile * wpr)
        row, word = divmod(rest, wpr)
        for bit in range(32):
            if v >> bit & 1:
                ra = int(work[t, 0]) + row
                cb = int(work[t, 1]) + 32 * word + bit
                tiles.setdefault(t, []).append(
                    (int(a_orig[ra]), int(b_orig[cb])))
    return {t: sorted(p) for t, p in tiles.items()}


def _extract_pairs(a, b, work, kw):
    """extract_tiles as find_pairs calls it: over the tiles of work (a
    host [T, 2] worklist) with matches, each at the slots that the
    exclusive prefix sum of count_tiles' counts gives it. Returns
    {tile of work: sorted [(a orig, b orig)] of its slots}."""
    counts = K.count_tiles(a, b, K.upload_worklist(work, "cpu"),
                           **kw).numpy().astype(np.int64)
    tiles = np.flatnonzero(counts)
    counts = counts[tiles]
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum())
    i1, i2 = K.extract_tiles(a, b, K.upload_worklist(work[tiles], "cpu"),
                             offsets=torch.from_numpy(offsets),
                             total=total, **kw)
    assert i1.dtype == i2.dtype == torch.int32
    assert i1.shape == i2.shape == (total,)
    return {t: sorted(zip(i1[lo:lo + n].tolist(), i2[lo:lo + n].tolist()))
            for t, lo, n in zip(tiles.tolist(), offsets.tolist(),
                                counts.tolist())}


def _assert_pairs(c, pairs):
    """The port's pairs, tile by tile, against the JAX package's: equal
    to its XLA extraction's records decoded bit by bit, whose word
    indices its Pallas kernel (interpret mode) gives too, and whose
    words it gives wherever their bits 15 and 31 are clear (see
    _INEXACT_BITS)."""
    k = 1 << 15
    xidx, xvals, xn, a_orig, b_orig = _xla_words(
        c.jdbs, c.ja["seqs"].shape[1], c.tile, c.work, c.d, c.indels,
        c.indel_only, c.xself, k)
    assert xn > 0
    assert pairs == _decode_words(xidx, xvals, c.work, a_orig, b_orig,
                                  c.tile)
    pidx, pvals, pn = c.extract_pallas(k)
    assert pn == xn
    np.testing.assert_array_equal(pidx, xidx)
    exact = (xvals & _INEXACT_BITS) == 0
    np.testing.assert_array_equal(pvals[exact], xvals[exact])


@pytest.mark.parametrize("d,indels,xself,self_cmp,stream", [
    (1, False, False, False, "all"),
    (1, True, True, True, "all"),
    (1, True, False, False, "indel_only"),
    (2, False, False, False, "all"),
])
def test_extract_tiles_plain_matches_pallas(dbs, d, indels, xself,
                                            self_cmp, stream):
    c = _Case(dbs, d, indels, xself, self_cmp, stream, "colmajor")
    _assert_pairs(c, _extract_pairs(c.ta, c.tb, c.work, c.kw))


@pytest.mark.parametrize("indels", [False, True])
def test_kernels_big_keys_match_pallas_legacy_path(dbs, indels):
    """Keys >= 2^29: JAX's len/v/j mask path against the port's int64
    key row, for counts and pairs."""
    c = _Case(dbs, 1, indels, False, False, "all", "colmajor", big=True)
    assert c.ta["key"].dtype == torch.int64
    np.testing.assert_array_equal(
        K.count_tiles(c.ta, c.tb, c.work_t, **c.kw).numpy(),
        c.count_pallas(),
    )
    _assert_pairs(c, _extract_pairs(c.ta, c.tb, c.work, c.kw))


# ---- extract_tiles' slots ---------------------------------------------


def _jax_db(db):
    """The JAX package's SeqDB of a port SeqDB's rows."""
    from compairr_tpu.core.db import GeneTables, SeqDB

    genes = GeneTables()
    for name in db.genes.v_names:
        genes.intern_v(name)
    for name in db.genes.j_names:
        genes.intern_j(name)
    return SeqDB(
        nucleotides=db.nucleotides, seqs=db.seqs, lengths=db.lengths,
        counts=db.counts, rep_no=db.rep_no, v_no=db.v_no, j_no=db.j_no,
        sequence_ids=db.sequence_ids, keep=db.keep,
        repertoire_ids=db.repertoire_ids, genes=genes,
        residues_count=db.residues_count,
        total_dup_count=db.total_dup_count, shortest=db.shortest,
        longest=db.longest,
    )


def _pair_inputs(lpad, self_cmp, cls):
    """(rows a, rows b, worklist tiles of class cls, the JAX package's
    SeqDBs of a and b) of test_torch_cuda's planted sets at lpad (24:
    one plane chunk of amino acids; 40: two), at 128-row tiles."""
    from test_torch_cuda import _concat, _planted_pair, _tile_cases

    d1, d2 = _planted_pair(lpad, nt=False)
    a, b, streams = _tile_cases(d1, d2, torch.device("cpu"), 128, self_cmp)
    assert a["seqs"].shape[1] == lpad
    work = next(w for w, c in streams if c == cls)
    jdbs = ((_jax_db(_concat(d1, d2)),) * 2 if self_cmp
            else (_jax_db(d1), _jax_db(d2)))
    return a, b, work, jdbs


@pytest.mark.parametrize("cls", [K.CLS_HAMMING, K.CLS_BOTH,
                                 K.CLS_INDEL_ONLY])
@pytest.mark.parametrize("self_cmp,xself", [(False, False), (False, True),
                                            (True, True)])
@pytest.mark.parametrize("lpad", [24, 40])
def test_extract_tiles_pairs_match_decoded_words(lpad, self_cmp, xself,
                                                 cls):
    """Each matched tile's pairs of original indices fill exactly the
    slots that the exclusive prefix sum of count_tiles' counts gives it,
    and are the pairs of the JAX package's extraction decoded bit by
    bit."""
    a, b, work, jdbs = _pair_inputs(lpad, self_cmp, cls)
    kw = dict(differences=1, cls=cls, exclude_self=xself, tile_m=128,
              tile_n=128)
    got = _extract_pairs(a, b, work, kw)
    assert got
    xidx, xvals, xn, a_orig, b_orig = _xla_words(
        jdbs, lpad, 128, work, 1, cls != K.CLS_HAMMING,
        cls == K.CLS_INDEL_ONLY, xself, 1 << 15)
    assert xn > 0
    np.testing.assert_array_equal(a_orig, a["orig"].numpy())
    np.testing.assert_array_equal(b_orig, b["orig"].numpy())
    assert got == _decode_words(xidx, xvals, work, a_orig, b_orig, 128)
    if xself:
        assert all(i != j for p in got.values() for i, j in p)


@pytest.mark.parametrize("slots", ["a_tile", "total", "a_tile_over"])
def test_extract_tiles_pairs_raise_on_short_offsets(slots):
    """Offsets one slot short (one tile's slots, or the total) or one
    slot over (one tile's) raise: the tiles' matches do not fill their
    slots."""
    a, b, work, _ = _pair_inputs(24, False, K.CLS_BOTH)
    kw = dict(differences=1, cls=K.CLS_BOTH, exclude_self=False,
              tile_m=128, tile_n=128)
    counts = K.count_tiles(a, b, K.upload_worklist(work, "cpu"),
                           **kw).numpy()
    work, counts = work[counts > 0], counts[counts > 0].astype(np.int64)
    assert len(work) > 1
    counts[0] += {"a_tile": -1, "total": 0, "a_tile_over": 1}[slots]
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum()) - (slots == "total")
    with pytest.raises(RuntimeError, match="do not fill its slots"):
        K.extract_tiles(a, b, K.upload_worklist(work, "cpu"),
                        offsets=torch.from_numpy(offsets), total=total,
                        **kw)
    with pytest.raises(ValueError, match="offsets"):
        K.extract_tiles(a, b, K.upload_worklist(work, "cpu"),
                        offsets=torch.from_numpy(offsets[:-1]),
                        total=total, **kw)


def test_tile_wrappers_check_inputs(dbs):
    c = _Case(dbs, 1, True, False, False, "all", "colmajor")
    ta, tb, wd, kw = c.ta, c.tb, c.work_t, c.kw
    with pytest.raises(ValueError, match="rseqs"):
        K.count_tiles(dict(ta, rseqs=None), tb, wd, **kw)
    with pytest.raises(ValueError, match="key"):
        K.count_tiles(dict(ta, key=ta["key"].float()), tb, wd, **kw)
    with pytest.raises(ValueError, match="work"):
        K.count_tiles(ta, tb, wd.long(), **kw)
    with pytest.raises(ValueError, match="tile_n"):
        K.count_tiles(ta, tb, wd, **dict(kw, tile_n=100))
    with pytest.raises(RuntimeError, match="outside the row sets"):
        K.count_tiles(ta, tb, wd + (1 << 20), **kw)
    with pytest.raises(ValueError, match="tile class"):
        K.count_tiles(ta, tb, wd, **dict(kw, cls=3))


# ---- find_pairs -----------------------------------------------------


def _sorted(res):
    i1, i2, dist = res
    o = np.lexsort((i2, i1))
    return i1[o], i2[o], (None if dist is None else dist[o])


def _assert_same_pairs(got, want):
    g, w = _sorted(got), _sorted(want)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])
    if w[2] is not None:
        np.testing.assert_array_equal(g[2], w[2])


def _jax_pairs(j1, j2, spec, monkeypatch, pigeonhole):
    """The JAX package's find_pairs under COMPAIRR_PIGEONHOLE=pigeonhole
    ("0": its tile route; "all": its host routes, which its own tests
    hold to its tile route)."""
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", pigeonhole)
    try:
        return jeng.find_pairs(j1, j2, jeng.MatchSpec(*spec))
    finally:
        monkeypatch.delenv("COMPAIRR_PIGEONHOLE")


def _port_tiles(t1, t2, spec, monkeypatch, pigeonhole="0"):
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", pigeonhole)
    try:
        res = teng.find_pairs(t1, t2, teng.MatchSpec(*spec), device="cpu")
    finally:
        monkeypatch.delenv("COMPAIRR_PIGEONHOLE")
    if spec[0] > 0:
        assert teng.LAST_ROUTE == "tiles"
    return res


@pytest.mark.parametrize(
    "d,indels,genes,self_ex",
    [
        (0, False, False, False),
        (1, False, False, False),
        (1, True, False, False),
        (1, True, True, False),
        (2, False, False, False),
        (3, False, True, False),
        (1, True, False, True),
    ],
)
def test_find_pairs_tiles_matches_oracle_and_jax(d, indels, genes, self_ex,
                                                 monkeypatch):
    """tests/test_oracle.py's brute-force cases (lengths 1..7, a
    3-letter alphabet, a self-comparison) through the port's tile
    route."""
    import random

    rng = random.Random(d * 100 + indels * 10 + genes)
    seqs = []
    for _ in range(180):
        ln = rng.randint(1, 7)
        seqs.append([rng.randrange(3) for _ in range(ln)])
    vs = [rng.randrange(2) for _ in seqs]
    js = [rng.randrange(2) for _ in seqs]
    jdb = make_db(seqs, vs, js)
    tdb = seqdb_from_arrays(jdb)
    spec = (d, indels, genes, self_ex)
    got = _port_tiles(tdb, tdb, spec, monkeypatch)
    assert set(zip(got[0].tolist(), got[1].tolist())) == oracle_pairs(
        jdb, jdb, jeng.MatchSpec(*spec)
    )
    _assert_same_pairs(
        got, _jax_pairs(jdb, jdb, spec, monkeypatch, "all" if indels else "0")
    )
    for a, b, dd in zip(*got):
        la, lb = jdb.lengths[a], jdb.lengths[b]
        if la == lb:
            assert dd == hamming(list(jdb.seqs[a, :la]), list(jdb.seqs[b, :lb]))
        else:
            assert dd == 1


def test_find_pairs_default_indel_route_matches_jax(dbs, monkeypatch):
    """-d 1 -i takes the tile route by default, in both packages."""
    (j1, j2), (t1, t2) = dbs
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    want = jeng.find_pairs(j1, j2, jeng.MatchSpec(1, True, False))
    assert jeng.LAST_ROUTE == "tiles"
    got = teng.find_pairs(t1, t2, teng.MatchSpec(1, True, False),
                          device="cpu")
    assert teng.LAST_ROUTE == "tiles"
    _assert_same_pairs(got, want)
    assert (got[2] == 1).any() and (got[2] == 0).any()
    # want_dist=False skips the distances
    got = teng.find_pairs(t1, t2, teng.MatchSpec(1, True, False),
                          device="cpu", want_dist=False)
    assert got[2] is None
    _assert_same_pairs(got, (want[0], want[1], None))


@pytest.mark.parametrize("spec,self_cmp", [
    ((1, True, False, False), False),
    ((1, True, False, True), True),
    ((2, False, False, False), False),
    ((2, False, False, False), True),
    ((1, False, True, False), False),
])
def test_find_pairs_tiles_matches_jax(dbs, spec, self_cmp, monkeypatch):
    (j1, j2), (t1, t2) = dbs
    if self_cmp:
        j2, t2 = j1, t1
    got = _port_tiles(t1, t2, spec, monkeypatch)
    want = _jax_pairs(j1, j2, spec, monkeypatch, "all" if spec[1] else "0")
    _assert_same_pairs(got, want)
    # a self-comparison without exclude_self adds its diagonal
    assert len(got[0]) > (j1.n if self_cmp and not spec[3] else 0)


@pytest.mark.parametrize("indels", [False, True])
def test_find_pairs_big_keys_matches_jax(dbs, indels, monkeypatch):
    (j1, j2), (t1, t2) = _sides(dbs, True)
    spec = (1, indels, False, False)
    got = _port_tiles(t1, t2, spec, monkeypatch)
    _assert_same_pairs(
        got, _jax_pairs(j1, j2, spec, monkeypatch, "all" if indels else "0")
    )
    assert len(got[0])


@pytest.mark.parametrize("d,indels", [(1, True), (2, False)])
def test_find_pairs_mixed_key_widths_matches_oracle(d, indels, monkeypatch):
    """Only set 2 holds bucket keys >= 2^29 (V gene indices of 8192 and
    more): both sets then take int64 key rows, and the pairs equal the
    brute-force oracle's."""
    import random

    rng = random.Random(43 + d)
    seqs = [[rng.randrange(3) for _ in range(rng.randint(3, 7))]
            for _ in range(120)]
    vs = [rng.randrange(2) for _ in seqs]
    js = [rng.randrange(2) for _ in seqs]
    j1 = make_db(seqs, vs, js)
    # set 2: set 1's rows, each with one random edit, and a tail of rows
    # on large V indices (same J table, so the keys stay comparable)
    seqs2, vs2 = [], []
    for s, v in zip(seqs, vs):
        s = list(s)
        kind, pos = rng.randrange(3), rng.randrange(len(s))
        if kind == 0:
            s[pos] = (s[pos] + 1) % 3
        elif kind == 1:
            del s[pos]
        else:
            s.insert(pos, rng.randrange(3))
        seqs2.append(s)
        vs2.append(v)
    for _ in range(20):
        seqs2.append([rng.randrange(3) for _ in range(rng.randint(3, 7))])
        vs2.append((1 << 13) + rng.randrange(2))
    j2 = make_db(seqs2, vs2, js + [rng.randrange(2) for _ in range(20)])
    t1, t2 = seqdb_from_arrays(j1), seqdb_from_arrays(j2)
    ka = teng.pack_keys(t1, TILE, True)[1][: t1.n]
    kb = teng.pack_keys(t2, TILE, True)[1][: t2.n]
    assert not K.wide_keys(ka) and K.wide_keys(kb)
    spec = (d, indels, False, False)
    got = _port_tiles(t1, t2, spec, monkeypatch)
    pairs = set(zip(got[0].tolist(), got[1].tolist()))
    assert pairs == oracle_pairs(j1, j2, jeng.MatchSpec(*spec))
    assert len(pairs) > 10
    for a, b, dd in zip(*got):
        la, lb = j1.lengths[a], j2.lengths[b]
        want = (hamming(list(j1.seqs[a, :la]), list(j2.seqs[b, :lb]))
                if la == lb else 1)
        assert dd == want


def test_find_pairs_nucleotides_matches_jax(tmp_path, monkeypatch):
    """Nucleotide rows (pad residue 4, lpad 40 > 32), self-comparison,
    with one indel."""
    (j1, _), (t1, _) = read_pair(
        *write_pair(tmp_path, nt=True, alphabet_sub=2, len_range=(33, 36)),
        nucleotides=True,
    )
    assert t1.pad_value == 4 and t1.longest > 32
    for spec in ((1, True, True, False), (2, False, True, False)):
        got = _port_tiles(t1, t1, spec, monkeypatch)
        want = _jax_pairs(j1, j1, spec, monkeypatch, "all")
        _assert_same_pairs(got, want)
        assert len(got[0]) > t1.n


def test_pigeonhole_overflow_reaches_tiles(monkeypatch):
    """A candidate-budget overflow reroutes the port to the tile route,
    with the JAX package's pairs (test_oracle's overflow case)."""
    import random

    rng = random.Random(41)
    seqs = [[rng.randrange(2) for _ in range(rng.randint(3, 5))]
            for _ in range(400)]
    jdb = make_db(seqs, [0] * len(seqs), [0] * len(seqs))
    tdb = seqdb_from_arrays(jdb)
    monkeypatch.setattr(tsh, "PIGEONHOLE_MAX_CANDIDATES", 10)
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    got = teng.find_pairs(tdb, tdb, teng.MatchSpec(1, False, False),
                          device="cpu")
    assert teng.LAST_ROUTE == "tiles"
    want = jeng.find_pairs(jdb, jdb, jeng.MatchSpec(1, False, False))
    _assert_same_pairs(got, want)


def test_find_pairs_device_from_env(dbs, monkeypatch):
    """COMPAIRR_DEVICE=cpu is the CLI's CPU request."""
    (_, _), (t1, t2) = dbs
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    spec = teng.MatchSpec(1, True, False)
    _assert_same_pairs(
        teng.find_pairs(t1, t2, spec),
        teng.find_pairs(t1, t2, spec, device="cpu"),
    )


# ---- routing constants and the prefetch ------------------------------


@dataclass
class _Fake:
    n: int
    longest: int = 14


def test_route_profile_and_pair_plan():
    """The routing constants, measured on an H100 (chip_smoke.py phases
    12, 19 and --cold-tiles): 512-row tiles on CUDA at every size, 128
    on the CPU and where a tile is asked for; another card only from 3M
    worklist tiles a card."""
    spec = teng.MatchSpec(1, True, False)
    assert teng.TILES_PER_DEVICE_MIN == 3_000_000
    for n1, n2 in ((1, 1), (4_000_000, 10), (1, 4_000_001)):
        assert teng._pair_plan(_Fake(n1), _Fake(n2), spec, "cuda")[0] == 512
    plan = teng._pair_plan(_Fake(4_000_000), _Fake(10), spec, "cuda", 128)
    assert plan == (128, 16, True, True)
    # the CPU keeps 128 tiles
    assert teng._pair_plan(_Fake(9_000_000), _Fake(1), spec, "cpu")[0] == 128
    # lpad rounds the longest sequence up to 8; -g and -d 2 drop the
    # key grouping and the indel rows
    assert teng._pair_plan(_Fake(5, 17), _Fake(5), teng.MatchSpec(2, True, True),
                           "cuda")[1:] == (24, False, False)


def test_prefetch_joins_and_reraises(dbs, monkeypatch):
    """The prefetch computes find_pairs on a worker that the next call
    joins; a failure on the worker is re-raised there, not recomputed.
    It starts for the runs that card_route sends to the tile route and
    for no other."""
    (_, _), (t1, t2) = dbs
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    spec = teng.MatchSpec(1, True, False)
    teng.prefetch_find_pairs(t1, t2, spec, want_dist=True)
    assert teng._RESULT_PREFETCH
    got = teng.find_pairs(t1, t2, spec)
    assert not teng._RESULT_PREFETCH
    _assert_same_pairs(got, teng.find_pairs(t1, t2, spec, device="cpu"))

    def boom(*a, **k):
        raise RuntimeError("worker failed")

    monkeypatch.setattr(K, "count_tiles", boom)
    teng.prefetch_find_pairs(t1, t2, spec, want_dist=True)
    with pytest.raises(RuntimeError, match="worker failed"):
        teng.find_pairs(t1, t2, spec)

    # a -d 2 run prefetches where it takes the tile route (=0; on the
    # CPU the rule keeps it on the host otherwise), and host routes
    # prefetch nothing
    monkeypatch.undo()
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    d2 = teng.MatchSpec(2, False, False)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    teng.prefetch_find_pairs(t1, t2, d2)
    assert teng._RESULT_PREFETCH
    teng.find_pairs(t1, t2, d2, want_dist=False)
    assert not teng._RESULT_PREFETCH and teng.LAST_ROUTE == "tiles"
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE")
    teng.prefetch_find_pairs(t1, t2, d2)
    assert not teng._RESULT_PREFETCH
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    teng.prefetch_find_pairs(t1, t2, spec)
    assert not teng._RESULT_PREFETCH


def test_tile_route_rejects_a_device_split(dbs):
    """A device split over no device at all raises; it never falls back
    to a device the caller did not list."""
    (_, _), (t1, t2) = dbs
    with pytest.raises(ValueError, match="at least one device"):
        teng.find_pairs(t1, t2, teng.MatchSpec(1, True, False), devices=[])


def test_tile_route_splits_class_streams_over_devices(dbs, monkeypatch):
    """Over 4 devices (utils.device.local_devices) the route splits each
    class stream into 4 contiguous spans, counted in span order on their
    replicas, and returns one device's pairs."""
    import torch

    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils import device as D

    (_, _), (t1, t2) = dbs
    spec = teng.MatchSpec(1, True, False)
    want = teng.find_pairs(t1, t2, spec, device="cpu")
    calls = []
    count_tiles = K.count_tiles

    def counted(a, b, work, **kw):
        calls.append((id(a), kw["cls"], work.numpy().copy()))
        return count_tiles(a, b, work, **kw)

    monkeypatch.setattr(teng, "TILES_PER_DEVICE_MIN", 1)
    monkeypatch.setattr(D, "local_devices",
                        lambda *_: [torch.device("cpu")] * 4)
    monkeypatch.setattr(K, "count_tiles", counted)
    got = teng.find_pairs(t1, t2, spec, device="cpu")
    assert len({a for a, _, _ in calls}) == 1  # one shared CPU replica
    classes = {c for _, c, _ in calls}
    assert len(calls) > len(classes)
    for cls in classes:
        spans = [w for _, c, w in calls if c == cls]
        whole = np.concatenate(spans)
        sizes = [len(w) for w in spans]
        assert len(spans) == min(4, len(whole))
        assert max(sizes) - min(sizes) <= 1
        assert (np.lexsort((whole[:, 0], whole[:, 1]))
                == np.arange(len(whole))).all()  # column-major, in order
    key = lambda r: sorted(zip(r[0].tolist(), r[1].tolist()))  # noqa: E731
    assert key(got) == key(want) and len(want[0]) > 0
