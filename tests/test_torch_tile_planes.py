"""The residue bit planes that csrc/tile_match.cu reads
(compairr_tpu_torch.ops.kernels.device_rows_raw with planes), on the
CPU:

  * the derive against a numpy bit-by-bit reference of the key-sorted
    rows and of the rows reversed within their lengths, at every chunk
    count the kernels distinguish (lpad 8 to 136), for amino acids (5
    planes) and nucleotides (3), with pad rows and bit 31 set;
  * the kernels' pair test written on planes in PyTorch (Hamming from
    popcounts; first mismatch, prefix and suffix from the lowest set bit
    of the first nonzero chunk mask) against the byte criterion of
    count_tiles_plain, mask for mask, on random and planted rows;
  * asking for planes changes no count and no pair against the JAX
    package's count kernel (interpret mode) and extraction;
  * where the engine asks for planes, and the wrappers' checks of them.

Every quantity is an integer, so equality is exact."""

from functools import partial

import numpy as np
import pytest
import torch

from compairr_tpu_torch.core.db import GeneTables, SeqDB
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from test_torch_tiles import _Case, _assert_pairs, _extract_pairs
from torch_port_data import read_pair, write_pair

LPADS = [8, 24, 32, 40, 96, 136]  # C = 1, 1, 1, 2, 3, 5
ALPHABETS = [("aa", False), ("nt", True)]


def _db(n, lpad, nt, seed, src=None, short=False):
    """A SeqDB of n rows (2 V and 2 J genes, lengths lpad - 10 to lpad,
    every fifth row of length lpad with the largest real code at both
    ends, so bit 31 of plane 0 is set at lpad = 32); with src, a third
    of its rows are src rows with one substitution, deletion or
    insertion; short: the other rows 1 to 8 long, from 3 codes, so that
    random rows match at small distances."""
    rng = np.random.default_rng(seed)
    alpha = 4 if nt else 20
    lo, hi = (1, min(8, lpad)) if short else (max(1, lpad - 10), lpad)
    lengths = rng.integers(lo, hi + 1, n).astype(np.int32)
    lengths[::5] = lpad
    seqs = np.full((n, lpad), alpha, dtype=np.int8)
    real = np.arange(lpad)[None, :] < lengths[:, None]
    seqs[real] = rng.integers(0, 3 if short else alpha, int(real.sum()),
                              dtype=np.int8)
    seqs[::5, 0] = seqs[::5, lpad - 1] = alpha - 1
    v_no = rng.integers(0, 2, n).astype(np.int32)
    j_no = rng.integers(0, 2, n).astype(np.int32)
    if src is not None:
        for t in rng.choice(n, n // 3, replace=False):
            s = int(rng.integers(0, src.n))
            row = list(src.seqs[s, : src.lengths[s]])
            pos = int(rng.integers(0, len(row)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                row[pos] = (row[pos] + 1) % alpha
            elif kind == 1 and len(row) > 1:
                del row[pos]
            else:
                row.insert(pos, int(rng.integers(0, alpha)))
            row = row[:lpad]
            seqs[t] = alpha
            seqs[t, : len(row)] = row
            lengths[t] = len(row)
            v_no[t], j_no[t] = src.v_no[s], src.j_no[s]
    genes = GeneTables()
    for name in ("V0", "V1"):
        genes.intern_v(name)
    for name in ("J0", "J1"):
        genes.intern_j(name)
    return SeqDB(
        nucleotides=nt, seqs=seqs, lengths=lengths,
        counts=np.ones(n, np.int64), rep_no=np.zeros(n, np.int32),
        v_no=v_no, j_no=j_no, sequence_ids=[None] * n, keep=[None] * n,
        repertoire_ids=["R0"], genes=genes,
        residues_count=int(lengths.sum()), total_dup_count=n,
        shortest=int(lengths.min()), longest=int(lengths.max()),
    )


def _rows(db, lpad, tile, indels, salt=0, by_vjl=True, planes=True):
    order, key, npad = teng.pack_keys(db, tile, by_vjl)
    rows = K.device_rows_raw(db, order, npad, lpad, indels, key, salt,
                             "cpu", wide=K.wide_keys(key[: db.n]),
                             planes=planes)
    return rows, order, key


def _planes_ref(rows_i8, n_planes):
    """numpy, bit by bit: word [row, c, q] bit p = bit q of residue
    32 c + p, 0 past lpad; as int32 (bit 31 is the sign bit)."""
    n, lpad = rows_i8.shape
    out = np.zeros((n, -(-lpad // 32), n_planes), dtype=np.uint32)
    for pos in range(lpad):
        for q in range(n_planes):
            bit = ((rows_i8[:, pos].astype(np.uint32) >> q) & 1) << (pos % 32)
            out[:, pos // 32, q] |= bit.astype(np.uint32)
    return out.view(np.int32)


@pytest.mark.parametrize("alpha,nt", ALPHABETS, ids=[a for a, _ in ALPHABETS])
@pytest.mark.parametrize("lpad", LPADS)
def test_device_rows_raw_planes_match_bitwise_reference(lpad, alpha, nt):
    """planes and rplanes of device_rows_raw against numpy, from the
    SeqDB itself: its rows in key order, pad rows all pad, and each row
    reversed within its length."""
    db = _db(90, lpad, nt, seed=lpad)
    rows, order, key = _rows(db, lpad, 64, indels=True)
    npad = len(key)
    pad = int(db.pad_value)
    n_planes = pad.bit_length()
    fwd = np.full((npad, lpad), pad, dtype=np.int8)
    fwd[: db.n] = db.seqs[order]
    rev = np.full_like(fwd, pad)
    for i, r in enumerate(order):
        ln = db.lengths[r]
        rev[i, :ln] = db.seqs[r, :ln][::-1]
    for name, ref in (("planes", fwd), ("rplanes", rev)):
        got = rows[name]
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert got.shape == (npad, K.plane_chunks(lpad), n_planes)
        np.testing.assert_array_equal(got.numpy(), _planes_ref(ref, n_planes))
    assert npad > db.n  # pad rows checked too
    if lpad >= 32:
        assert (rows["planes"].numpy() < 0).any()  # bit 31 in use
    plain, _, _ = _rows(db, lpad, 64, indels=True, planes=False)
    assert "planes" not in plain and "rplanes" not in plain
    only_fwd, _, _ = _rows(db, lpad, 64, indels=False)
    assert "rplanes" not in only_fwd
    torch.testing.assert_close(only_fwd["planes"], rows["planes"],
                               rtol=0, atol=0)


# ---- the pair test on planes -----------------------------------------

_POPC8 = torch.tensor([bin(i).count("1") for i in range(256)])


def _masks(pa, pb):
    """int64 [..., C] chunk masks OR_q (A_q ^ B_q) of plane rows
    [..., C, P] (int32 words read as unsigned)."""
    x = (pa.long() ^ pb.long()) & 0xFFFFFFFF
    m = x[..., 0]
    for q in range(1, x.shape[-1]):
        m = m | x[..., q]
    return m


def _popc(m):
    return sum(_POPC8[(m >> (8 * k)) & 255] for k in range(4))


def _first_mismatch(m, lpad):
    """Position of the first differing residue from chunk masks [..., C]:
    32 c + ctz(m_c) of the first nonzero chunk (the lowest set bit
    m & -m is a power of two, exact in float64), lpad when none."""
    n_chunks = m.shape[-1]
    low = m & -m
    tz = torch.log2(low.clamp(min=1).double()).round().long()
    pos = torch.where(m != 0, tz + 32 * torch.arange(n_chunks), 32 * n_chunks)
    return pos.min(-1).values.clamp(max=lpad)


def _plane_match_tiles(a, b, work, *, differences, cls, exclude_self,
                       tile_m, tile_n):
    """bool [B, TM, TN]: csrc/tile_match.cu's pair test, on planes."""
    lpad = a["seqs"].shape[1]
    ra = work[:, :1].long() + torch.arange(tile_m)
    cb = work[:, 1:].long() + torch.arange(tile_n)
    ka = a["key"][ra].long()[:, :, None]
    kb = b["key"][cb].long()[:, None, :]
    fwd = _masks(a["planes"][ra][:, :, None], b["planes"][cb][:, None])
    hit = torch.zeros(fwd.shape[:3], dtype=torch.bool)
    if cls != K.CLS_INDEL_ONLY:
        hit |= (ka == kb) & (_popc(fwd).sum(-1) <= differences)
    if cls != K.CLS_HAMMING:
        rev = _masks(a["rplanes"][ra][:, :, None], b["rplanes"][cb][:, None])
        pre = _first_mismatch(fwd, lpad)
        suf = _first_mismatch(rev, lpad)
        minlen = torch.minimum(ka & 0xFFFF, kb & 0xFFFF)
        hit |= ((ka - kb).abs() == 1) & (pre + suf >= minlen)
    if exclude_self:
        hit &= a["orig"][ra][:, :, None] != b["orig"][cb][:, None, :]
    return hit


def _pair_cases(kind, lpad, nt):
    """(rows a, rows b) of two sets at width lpad: random rows, or a set
    with near-duplicates of the other planted."""
    random = kind == "random"
    d1 = _db(150, lpad, nt, seed=7, short=random)
    d2 = _db(180, lpad, nt, seed=8, src=None if random else d1, short=random)
    a, _, ka = _rows(d1, lpad, 32, indels=True)
    b, _, kb = _rows(d2, lpad, 32, indels=True, salt=2)
    work = teng.worklist_from_keys(ka, d1.n, kb, d2.n, 1, 32, 32)
    return a, b, K.upload_worklist(work, "cpu")


@pytest.mark.parametrize("kind", ["random", "planted"])
@pytest.mark.parametrize("lpad,nt", [(24, False), (40, False), (48, True),
                                     (96, True)])
def test_plane_pair_test_equals_byte_criterion(kind, lpad, nt):
    a, b, work = _pair_cases(kind, lpad, nt)
    matched = 0
    for cls in (K.CLS_HAMMING, K.CLS_BOTH, K.CLS_INDEL_ONLY):
        for d, xself in ((1, False), (2, True), (3, False)):
            kw = dict(differences=d, cls=cls, exclude_self=xself,
                      tile_m=32, tile_n=32)
            got = _plane_match_tiles(a, b, work, **kw)
            want = K._match_tiles_plain(a, b, work, **kw)
            assert torch.equal(got, want), (cls, d, xself)
            counts = K.count_tiles_plain(a, b, work, **kw)
            assert torch.equal(got.sum((1, 2)).to(torch.int32), counts)
            matched += int(counts.sum())
    assert matched > 0


def test_plane_first_mismatch_and_popcount_on_planted_rows():
    """Rows that differ at one chosen position (every position of every
    chunk, bit 31 included): the masks' popcount is 1 and their first
    mismatch is that position; equal rows give 0 and lpad."""
    lpad = 136
    rng = np.random.default_rng(5)
    base = rng.integers(0, 20, lpad).astype(np.int8)
    rows = np.repeat(base[None], lpad + 1, axis=0)
    for p in range(lpad):
        rows[p + 1, p] = (rows[p + 1, p] + 1 + p % 19) % 20
    planes = K.residue_planes(torch.from_numpy(rows), 5)
    m = _masks(planes[:1], planes)
    np.testing.assert_array_equal(_popc(m).sum(-1).numpy(),
                                  [0] + [1] * lpad)
    np.testing.assert_array_equal(_first_mismatch(m, lpad).numpy(),
                                  [lpad] + list(range(lpad)))


# ---- against the JAX package's kernels -------------------------------

@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("tile_planes")))


def _planes_case(monkeypatch, dbs, *args):
    """test_torch_tiles' case with the port's rows derived with planes."""
    monkeypatch.setattr(K, "device_rows_raw",
                        partial(K.device_rows_raw, planes=True))
    c = _Case(dbs, *args)
    monkeypatch.undo()
    assert "planes" in c.ta and "planes" in c.tb
    assert ("rplanes" in c.ta) == c.indels
    return c


@pytest.mark.parametrize("d,indels,xself,self_cmp,stream", [
    (1, True, False, False, "all"),
    (1, True, True, True, "all"),
    (1, True, False, False, "indel_only"),
    (2, False, True, False, "all"),
])
def test_planes_change_no_count_or_record_against_pallas(
        monkeypatch, dbs, d, indels, xself, self_cmp, stream):
    c = _planes_case(monkeypatch, dbs, d, indels, xself, self_cmp, stream,
                     "colmajor")
    want = c.count_pallas()
    got = K.count_tiles(c.ta, c.tb, c.work_t, **c.kw)
    np.testing.assert_array_equal(got.numpy(), want)
    masks = _plane_match_tiles(c.ta, c.tb, c.work_t, **c.kw)
    np.testing.assert_array_equal(masks.sum((1, 2)).numpy(), want)
    _assert_pairs(c, _extract_pairs(c.ta, c.tb, c.work, c.kw))


# ---- the engine and the wrappers ---------------------------------------

def test_sparse_inputs_ask_for_planes_only_on_cuda(dbs):
    (_, _), (t1, t2) = dbs
    lpad = teng._round_up(int(max(t1.longest, t2.longest)), 8)
    (a, _), (b, _) = teng._sparse_inputs(
        t1, t2, 128, True, lpad, torch.device("cpu"), True
    )
    for side in (a, b):
        assert "planes" not in side and "rplanes" not in side


def test_tile_wrappers_check_planes(monkeypatch, dbs):
    c = _planes_case(monkeypatch, dbs, 1, True, False, False, "all",
                     "colmajor")
    ta, tb, wd, kw = c.ta, c.tb, c.work_t, c.kw
    with pytest.raises(ValueError, match="rplanes"):
        K.count_tiles(dict(ta, rplanes=None), tb, wd, **kw)
    with pytest.raises(ValueError, match="planes"):
        K.count_tiles(ta, dict(tb, planes=tb["planes"][:, :, :3]), wd, **kw)
    with pytest.raises(ValueError, match="planes"):
        K.extract_tiles(dict(ta, planes=ta["planes"].long()), tb, wd,
                        offsets=torch.zeros(len(wd), dtype=torch.int64),
                        total=0, **kw)
    three = {k: K.residue_planes(tb[s], 3)
             for k, s in (("planes", "seqs"), ("rplanes", "rseqs"))}
    with pytest.raises(ValueError, match="differ in number"):
        K.count_tiles(ta, dict(tb, **three), wd, **kw)
    # without planes on either side the plain version runs as before
    ba, bb = ({k: v for k, v in side.items()
               if k not in ("planes", "rplanes")} for side in (ta, tb))
    np.testing.assert_array_equal(K.count_tiles(ba, bb, wd, **kw).numpy(),
                                  c.count_pallas())
