"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; each test skips when no CUDA device is present.
This file imports neither JAX nor the JAX package, so on a machine
without JAX it runs with pytest's --noconftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io.airr import read_db
    from compairr_tpu_torch.utils.progress import NullLogger
    from synth import make_tsv

    d = tmp_path_factory.mktemp("cuda")
    shape = dict(alphabet_sub=3, n_v=2, n_j=2, len_range=(6, 9),
                 max_count=3)
    a = make_tsv(str(d / "a.tsv"), 3000, 5, seed=31, **shape)
    b = make_tsv(str(d / "b.tsv"), 3500, 7, seed=32, **shape)
    genes = GeneTables()
    log = NullLogger()
    return (read_db(a, Options(), genes, log, False, "1"),
            read_db(b, Options(), genes, log, False, "2"))


def _inputs(sets, dev, tile):
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = sets
    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tile, True)
    ob, kb, nb = E.pack_keys(d2, tile, True)
    work = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, 0, tile, tile)
    )
    return (K.device_args_raw(d1, oa, na, lpad, ka, dev, planes=True),
            K.device_args_raw(d2, ob, nb, lpad, kb, dev, planes=True),
            K.upload_worklist(work, dev))


@pytest.mark.parametrize("tile", [128, 768])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_dense_match_kernel_equals_plain(cuda, sets, tile, d):
    import torch

    from compairr_tpu_torch.ops import kernels as K

    a, b, work = _inputs(sets, cuda, tile)
    for mode in (K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX, K.SC_SUM):
        kw = dict(differences=d, score_mode=mode, tile_m=tile,
                  tile_n=tile, r1p=8, r2p=128)
        before = K.LAUNCHES["dense_match"]
        got = K.dense_match(a, b, work, **kw)
        assert K.LAUNCHES["dense_match"] == before + 1
        want = K.dense_match_plain(a, b, work, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (mode, d, tile)
        assert int(want.sum()) > 0


def test_dense_match_nucleotides_equals_plain(cuda, tmp_path):
    """Nucleotide rows: pad residue 4, lpad 40 (ten words a row)."""
    import torch

    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io.airr import read_db
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils.progress import NullLogger
    from synth import make_tsv

    path = make_tsv(str(tmp_path / "nt.tsv"), 3000, 5, seed=33, nt=True,
                    alphabet_sub=2, len_range=(33, 36), max_count=3)
    db = read_db(path, Options(nucleotides=True), GeneTables(),
                 NullLogger(), False, "1")
    a, b, work = _inputs((db, db), cuda, 768)
    assert a["seqs"].shape[1] == 40
    for d in (0, 2):
        kw = dict(differences=d, score_mode=K.SC_PRODUCT, tile_m=768,
                  tile_n=768, r1p=8, r2p=128)
        got = K.dense_match(a, b, work, **kw)
        want = K.dense_match_plain(a, b, work, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and int(want.sum()) > 0


def test_dense_matrix_cuda_equals_cpu(cuda, sets):
    import numpy as np

    from compairr_tpu_torch.constants import SCORE_MEAN
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix

    d1, d2 = sets
    spec = MatchSpec(differences=2, indels=False, ignore_genes=True)
    got = dense_matrix(d1, d2, spec, SCORE_MEAN, False, device="cuda")
    want = dense_matrix(d1, d2, spec, SCORE_MEAN, False, device="cpu")
    np.testing.assert_array_equal(got, want)


def _planted_db(n, len_range, seed, nt=False, src=None, frac=0.2,
                v_offset=0):
    """A SeqDB of n random rows (2 V and 2 J genes); with src, about
    frac of its rows are copies of src rows with one substitution,
    deletion or insertion, so that Hamming and indel matches exist at
    any width. v_offset raises every V index (bucket keys >= 2^29 at
    2^13)."""
    import numpy as np

    from compairr_tpu_torch.core.db import GeneTables, SeqDB

    rng = np.random.default_rng(seed)
    alpha, pad = (4, 4) if nt else (20, 20)
    lengths = rng.integers(len_range[0], len_range[1] + 1, n).astype(np.int32)
    width = len_range[1] + 1
    seqs = np.full((n, width), pad, dtype=np.int8)
    seqs[np.arange(width)[None, :] < lengths[:, None]] = rng.integers(
        0, alpha, int(lengths.sum()), dtype=np.int8
    )
    v_no = rng.integers(0, 2, n).astype(np.int32)
    j_no = rng.integers(0, 2, n).astype(np.int32)
    if src is not None:
        k = int(n * frac)
        for s, t in zip(rng.choice(src.n, k, replace=False),
                        rng.choice(n, k, replace=False)):
            row = list(src.seqs[s, : src.lengths[s]])
            pos = int(rng.integers(0, len(row)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                row[pos] = (row[pos] + 1) % alpha
            elif kind == 1 and len(row) > 1:
                del row[pos]
            else:
                row.insert(pos, int(rng.integers(0, alpha)))
            row = row[:width]
            seqs[t] = pad
            seqs[t, : len(row)] = row
            lengths[t] = len(row)
            v_no[t] = src.v_no[s] - v_offset
            j_no[t] = src.j_no[s]
    genes = GeneTables()
    for name in ("V0", "V1"):
        genes.intern_v(name)
    for name in ("J0", "J1"):
        genes.intern_j(name)
    return SeqDB(
        nucleotides=nt, seqs=seqs, lengths=lengths,
        counts=np.ones(n, np.int64), rep_no=np.zeros(n, np.int32),
        v_no=v_no + v_offset, j_no=j_no, sequence_ids=[None] * n,
        keep=[None] * n, repertoire_ids=["R0"], genes=genes,
        residues_count=int(lengths.sum()), total_dup_count=n,
        shortest=int(lengths.min()), longest=int(lengths.max()),
    )


def _planted_pair(lpad, v_offset=0, nt=None):
    """Two planted sets whose rows pad to lpad (24: amino acids up to
    23 long; above 32, nucleotides unless nt is False: 48 up to 47
    long, and so on)."""
    nt = lpad > 32 if nt is None else nt
    lr = (lpad - 8, lpad - 2)
    d1 = _planted_db(2000, lr, 41, nt, v_offset=v_offset)
    return d1, _planted_db(2500, lr, 42, nt, src=d1, v_offset=v_offset)


def _concat(d1, d2):
    """One set holding the rows of both (so that it holds planted pairs
    of its own)."""
    import numpy as np
    from dataclasses import replace

    cat = {f: np.concatenate([getattr(d1, f), getattr(d2, f)])
           for f in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")}
    n = d1.n + d2.n
    return replace(d1, **cat, sequence_ids=[None] * n, keep=[None] * n,
                   residues_count=int(cat["lengths"].sum()),
                   total_dup_count=n,
                   shortest=int(cat["lengths"].min()),
                   longest=int(cat["lengths"].max()))


def _tile_cases(d1, d2, dev, tile, self_cmp, by_vjl=True):
    """(rows a, rows b, [(worklist, class), ...]) of a -d 1 -i tile
    run, as engine.find_pairs builds them (rows with their residue
    planes), plus the Hamming class over every equal-key tile and the
    both class over every tile. A self-comparison compares the rows of
    both sets with themselves; by_vjl=False keys by length alone (-g)."""
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    if self_cmp:
        d1 = d2 = _concat(d1, d2)
    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tile, by_vjl)
    ob, kb, nb = E.pack_keys(d2, tile, by_vjl)
    wide = K.wide_keys(ka[: d1.n], kb[: d2.n])
    a = K.device_rows_raw(d1, oa, na, lpad, True, ka, 0, dev, wide=wide,
                          planes=True)
    b = a if self_cmp else K.device_rows_raw(d2, ob, nb, lpad, True, kb, 2,
                                             dev, wide=wide, planes=True)
    work = E.worklist_from_keys(ka, d1.n, kb, d2.n, 1, tile, tile)
    has_eq, has_pm = E.classify_worklist(work, ka, d1.n, kb, d2.n, tile,
                                         tile)
    streams = [
        (work[has_eq & ~has_pm], K.CLS_HAMMING),
        (work[has_eq & has_pm], K.CLS_BOTH),
        (work[~has_eq & has_pm], K.CLS_INDEL_ONLY),
        (work[has_eq], K.CLS_HAMMING),
        (work[has_eq | has_pm], K.CLS_BOTH),
    ]
    return a, b, [(E.order_colmajor(w), c) for w, c in streams if len(w)]


def _check_pairs_equal_plain(a, b, work, counts, kw, dev):
    """extract_tiles on the matched tiles of work (counts:
    count_tiles' int32 host counts) against its plain version: each
    tile's slots, from the exclusive prefix sum of the counts, hold the
    same pairs (in any order within the tile). Returns the pairs."""
    import numpy as np
    import torch

    from compairr_tpu_torch.ops import kernels as K

    nz = counts > 0
    mc = counts[nz].astype(np.int64)
    wd = K.upload_worklist(work[nz], dev)
    offsets = torch.from_numpy(np.cumsum(mc) - mc).to(dev)
    total = int(mc.sum())
    before = K.LAUNCHES["extract_tiles"]
    got = K.extract_tiles(a, b, wd, offsets=offsets, total=total, **kw)
    assert K.LAUNCHES["extract_tiles"] == before + int(total > 0)
    want = K.extract_tiles_plain(a, b, wd, offsets=offsets, total=total,
                                 **kw)
    tid = np.repeat(np.arange(len(mc)), mc)
    (g1, g2), (w1, w2) = ([x.cpu().numpy() for x in r] for r in (got, want))
    assert g1.dtype == np.int32 and len(g1) == len(g2) == total
    go, wo = np.lexsort((g2, g1, tid)), np.lexsort((w2, w1, tid))
    np.testing.assert_array_equal(g1[go], w1[wo])
    np.testing.assert_array_equal(g2[go], w2[wo])
    return total


def _check_tiles_equal_plain(a, b, streams, dev, tile, xself, ds=(1,)):
    import torch

    from compairr_tpu_torch.ops import kernels as K

    matched = 0
    for work, cls in streams:
        wd = K.upload_worklist(work, dev)
        for d in ds if cls == K.CLS_HAMMING else (1,):
            kw = dict(differences=d, cls=cls, exclude_self=xself,
                      tile_m=tile, tile_n=tile)
            before = dict(K.LAUNCHES)
            got = K.count_tiles(a, b, wd, **kw)
            want = K.count_tiles_plain(a, b, wd, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (cls, d, tile)
            total = int(want.sum())
            assert _check_pairs_equal_plain(
                a, b, work, want.cpu().numpy(), kw, dev) == total
            assert K.LAUNCHES["count_tiles"] == before["count_tiles"] + 1
            assert K.LAUNCHES["extract_tiles"] == (
                before["extract_tiles"] + int(total > 0))
            matched += total
    assert matched > 0


def _straddles(key, n, tile):
    """Whether some run of equal keys among the first n sorted keys
    crosses both a 32-row word edge and a tile edge."""
    import numpy as np

    edges = np.flatnonzero(np.diff(key[:n])) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [n]])
    word = (starts // 32) != ((ends - 1) // 32)
    tiles = (starts // tile) != ((ends - 1) // tile)
    return bool(word.any() and tiles.any())


@pytest.mark.parametrize("lpad", [24, 48, 136, 200])
@pytest.mark.parametrize("tile", [128, 512])
def test_tile_kernels_equal_plain(cuda, tile, lpad):
    """C = 1, 2, 5, 7 (lpad 136 and 200 take the runtime-C loop; at
    tile 512, lpad 200's b planes are staged in two column chunks), 5
    planes at lpad 24 and 3 (nucleotides) above; sets of 2,000 and
    2,500 rows, so the last tile of each is ragged (pads after the real
    rows); key runs of about 70 rows that cross word and tile edges; d 1
    to 3; two sets with exclude_self off and on, and a self-comparison."""
    d1, d2 = _planted_pair(lpad)
    for self_cmp, xself in ((False, False), (False, True), (True, True)):
        a, b, streams = _tile_cases(d1, d2, cuda, tile, self_cmp)
        assert a["seqs"].shape[1] == lpad
        assert a["planes"].shape[1:] == (-(-lpad // 32),
                                         5 if lpad < 32 else 3)
        key = a["key"].cpu().numpy()
        assert _straddles(key, int((a["orig"] >= 0).sum()), tile)
        _check_tiles_equal_plain(a, b, streams, cuda, tile, xself,
                                 ds=(1, 2, 3))


def test_tile_kernels_long_amino_acid_rows(cuda):
    """Amino-acid rows of 32 to 39 residues at lpad 40, as an IGH
    cohort's long junctions make them: two chunks of five planes (C = 2,
    P = 5, the compile-time path) at the route's 512-row tiles, on every
    tile class, d 1 to 3 on the Hamming class; two sets with
    exclude_self off and on, and a self-comparison; pair for pair
    against the plain version."""
    d1, d2 = _planted_pair(40, nt=False)
    assert d1.pad_value == 20 and max(d1.longest, d2.longest) > 32
    classes = set()
    for self_cmp, xself in ((False, False), (False, True), (True, True)):
        a, b, streams = _tile_cases(d1, d2, cuda, 512, self_cmp)
        assert a["seqs"].shape[1] == 40
        assert tuple(a["planes"].shape[1:]) == (2, 5)
        assert tuple(a["rplanes"].shape[1:]) == (2, 5)
        classes |= {c for _w, c in streams}
        _check_tiles_equal_plain(a, b, streams, cuda, 512, xself,
                                 ds=(1, 2, 3))
    assert classes == {0, 1, 2}


@pytest.mark.parametrize("tile", [128, 512])
def test_tile_kernels_single_key_tiles(cuda, tile):
    """-g: keys by length alone, so most tiles hold one or two keys and
    every a run's window spans whole tiles."""
    d1, d2 = _planted_pair(24)
    for self_cmp, xself in ((False, False), (True, True)):
        a, b, streams = _tile_cases(d1, d2, cuda, tile, self_cmp,
                                    by_vjl=False)
        _check_tiles_equal_plain(a, b, streams, cuda, tile, xself,
                                 ds=(1, 2, 3))


@pytest.mark.parametrize("lpad", [24, 40])
def test_extract_tiles_pair_mode_equals_plain(cuda, lpad):
    """extract_tiles, one launch a class, against its plain
    version at one plane chunk (lpad 24) and two (lpad 40, amino acids)
    at tiles 128 and 512 (the route's), every class, two sets and a
    self-comparison; offsets one slot short raise, and the card works
    on."""
    import numpy as np
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(lpad, nt=False)
    classes = set()
    for tile in (128, 512):
        for self_cmp, xself in ((False, False), (True, True)):
            a, b, streams = _tile_cases(d1, d2, cuda, tile, self_cmp)
            assert tuple(a["planes"].shape[1:]) == (-(-lpad // 32), 5)
            for work, cls in streams:
                kw = dict(differences=1, cls=cls, exclude_self=xself,
                          tile_m=tile, tile_n=tile)
                counts = K.count_tiles(a, b, K.upload_worklist(work, cuda),
                                       **kw).cpu().numpy()
                if _check_pairs_equal_plain(a, b, work, counts, kw, cuda):
                    classes.add(cls)
    assert classes == {0, 1, 2}
    # one tile's slots one short, then the total one short
    a, b, streams = _tile_cases(d1, d2, cuda, 512, False)
    work, cls = streams[0]
    kw = dict(differences=1, cls=cls, exclude_self=False, tile_m=512,
              tile_n=512)
    counts = K.count_tiles(a, b, K.upload_worklist(work, cuda),
                           **kw).cpu().numpy()
    work, mc = work[counts > 0], counts[counts > 0].astype(np.int64)
    wd = K.upload_worklist(work, cuda)
    for short in ("a_tile", "total"):
        c = mc.copy()
        if short == "a_tile":
            c[0] -= 1
        offsets = torch.from_numpy(np.cumsum(c) - c).to(cuda)
        total = int(c.sum()) - (short == "total")
        with pytest.raises(RuntimeError, match="do not fill its slots"):
            K.extract_tiles(a, b, wd, offsets=offsets, total=total, **kw)
    torch.cuda.synchronize()
    assert _check_pairs_equal_plain(a, b, work, mc.astype(np.int32), kw,
                                    cuda) == int(mc.sum())


def test_tile_kernels_require_planes(cuda):
    """On the card the tile kernels read only planes: a side without
    them (or without the reversed rows' planes on an indel class)
    raises, with no fallback to the residue rows."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    a, b, streams = _tile_cases(d1, d2, cuda, 128, False)
    work, cls = next((w, c) for w, c in streams if c == K.CLS_BOTH)
    wd = K.upload_worklist(work, cuda)
    kw = dict(differences=1, cls=cls, exclude_self=False, tile_m=128,
              tile_n=128)
    offsets = torch.zeros(len(work), dtype=torch.int64, device=cuda)

    def bare(side):
        return {k: v for k, v in side.items()
                if k not in ("planes", "rplanes")}

    before = dict(K.LAUNCHES)
    for strip in (bare, lambda side: dict(side, rplanes=None)):
        with pytest.raises(ValueError, match="planes"):
            K.count_tiles(strip(a), b, wd, **kw)
        with pytest.raises(ValueError, match="planes"):
            K.extract_tiles(a, strip(b), wd, offsets=offsets, total=0,
                            **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before


def test_tile_kernels_big_keys_equal_plain(cuda):
    """Keys >= 2^29: the int64 key row."""
    d1, d2 = _planted_pair(24, v_offset=1 << 13)
    a, b, streams = _tile_cases(d1, d2, cuda, 128, False)
    assert a["key"].dtype.itemsize == 8
    _check_tiles_equal_plain(a, b, streams, cuda, 128, False)


def _derive_db(n, w, lpad, nt, seed):
    """A SeqDB of n rows (2 V and 2 J genes) whose int8 rows are w wide:
    lengths 1 to min(w, lpad), pad after each row up to lpad, random
    codes past lpad (which the derive does not read)."""
    import numpy as np

    from compairr_tpu_torch.core.db import GeneTables, SeqDB

    rng = np.random.default_rng(seed)
    alpha = 4 if nt else 20
    seqs = rng.integers(0, alpha, (n, w), dtype=np.int8)
    lengths = rng.integers(1, min(w, lpad) + 1, n).astype(np.int32)
    pos = np.arange(w)[None, :]
    seqs[(pos >= lengths[:, None]) & (pos < lpad)] = alpha
    genes = GeneTables()
    for name in ("V0", "V1"):
        genes.intern_v(name)
    for name in ("J0", "J1"):
        genes.intern_j(name)
    return SeqDB(
        nucleotides=nt, seqs=seqs, lengths=lengths,
        counts=np.ones(n, np.int64), rep_no=np.zeros(n, np.int32),
        v_no=rng.integers(0, 2, n).astype(np.int32),
        j_no=rng.integers(0, 2, n).astype(np.int32),
        sequence_ids=[None] * n, keep=[None] * n, repertoire_ids=["R0"],
        genes=genes, residues_count=int(lengths.sum()), total_dup_count=n,
        shortest=int(lengths.min()) if n else 0,
        longest=int(lengths.max()) if n else 0,
    )


@pytest.mark.parametrize("nt", [False, True], ids=["aa", "nt"])
@pytest.mark.parametrize("lpad", [8, 24, 32, 40, 64, 96])
def test_derive_kernel_equals_plain(cuda, lpad, nt):
    """csrc/derive_rows.cu (C = 1 to 3; P = 5 for amino acids, 3 for
    nucleotides) against its plain version on the CPU, through
    device_rows_raw (int32 and int64 key rows, pad salts 0 and 2) and
    device_args_raw, with and without indels and planes, on rows
    narrower and wider than lpad and on sets of 0, 1 and 300 rows:
    every returned array torch.equal, one launch a derive."""
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    cpu = torch.device("cpu")
    for w in (max(1, lpad - 5), lpad + 7):
        for n in (0, 1, 300):
            db = _derive_db(n, w, lpad, nt, seed=lpad + w + n)
            order, key, npad = E.pack_keys(db, 128, True)
            calls = [
                (f"rows wide={wide} salt={salt}",
                 lambda dev, ind, pl, wide=wide, salt=salt: K.device_rows_raw(
                     db, order, npad, lpad, ind, key, salt, dev, wide=wide,
                     planes=pl))
                for wide in (False, True) for salt in (0, 2)]
            calls.append(("args", lambda dev, ind, pl: K.device_args_raw(
                db, order, npad, lpad, key, dev, indels=ind, planes=pl)))
            for label, call in calls:
                for indels in (False, True):
                    for planes in (False, True):
                        case = (label, w, n, indels, planes)
                        want = call(cpu, indels, planes)
                        before = K.LAUNCHES["derive_rows"]
                        got = call(cuda, indels, planes)
                        torch.cuda.synchronize()
                        assert K.LAUNCHES["derive_rows"] == before + 1, case
                        assert sorted(got) == sorted(want), case
                        for k, v in want.items():
                            if v is None:
                                assert got[k] is None, (k, case)
                                continue
                            assert got[k].device.type == "cuda", (k, case)
                            assert torch.equal(got[k].cpu(), v), (k, case)
                        assert ("rplanes" in got) == (indels and planes)


def test_derive_kernel_refuses_bad_inputs(cuda):
    """derive_rows raises on a wrong dtype, shape, layout or device,
    with no launch."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    rows = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    order = torch.arange(6, device=cuda)
    key = torch.zeros(6, dtype=torch.int32, device=cuda)
    before = dict(K.LAUNCHES)
    for bad in ((rows.int(), order, key), (rows.t(), order, key),
                (rows[0], order, key), (rows, order.int(), key),
                (rows, order, key[:5]), (rows, order, key.float()),
                (rows, order.cpu(), key)):
        with pytest.raises(ValueError, match="derive_rows"):
            K.derive_rows(*bad, 8, 20, indels=True, planes=True)
    with pytest.raises(ValueError, match="derive_rows"):
        K.derive_rows(rows, order, key, 8, 200, indels=True, planes=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before


@pytest.mark.parametrize("spec,self_cmp,pigeonhole", [
    ((1, True, False), False, "1"),
    ((1, True, False), True, "1"),
    ((1, True, True), False, "1"),
    ((2, False, False), False, "0"),
])
def test_find_pairs_cuda_equals_cpu(cuda, monkeypatch, spec, self_cmp,
                                    pigeonhole):
    import numpy as np

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    if self_cmp:
        d1 = d2 = _concat(d1, d2)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", pigeonhole)
    K.reset_launches()
    got = E.find_pairs(d1, d2, E.MatchSpec(*spec), device="cuda")
    assert E.LAST_ROUTE == "tiles"
    assert K.LAUNCHES["count_tiles"] >= 1 and K.LAUNCHES["extract_tiles"] >= 1
    want = E.find_pairs(d1, d2, E.MatchSpec(*spec), device="cpu")

    def key(r):
        o = np.lexsort((r[1], r[0]))
        return r[0][o], r[1][o], r[2][o]

    for g, w in zip(key(got), key(want)):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > (d1.n if self_cmp else 0)


def _counted(db, seed, high=100):
    """db with duplicate counts drawn from 1..high-1."""
    import numpy as np
    from dataclasses import replace

    rng = np.random.default_rng(seed)
    return replace(db, counts=rng.integers(1, high, db.n).astype(np.int64))


def _join_inputs(d1, d2, dev, tile, indels, wide, by_vjl=True):
    """dense_indel / dense_general inputs as engine.dense_matrix builds
    them, with the residue rows kept beside the planes that the kernels
    read, so that the plain versions run on the same inputs (a
    self-comparison shares one derive); by_vjl=False keys by length
    alone (-g)."""
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tile, by_vjl)
    ob, kb, nb = E.pack_keys(d2, tile, by_vjl)
    work = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), tile, tile)
    )
    a = K.device_args_raw(d1, oa, na, lpad, ka, dev, indels=indels,
                          wide=wide, planes=True)
    b = a if d2 is d1 else K.device_args_raw(d2, ob, nb, lpad, kb, dev,
                                             indels=indels, wide=wide,
                                             planes=True)
    return a, b, K.upload_worklist(work, dev)


# (kernel, indels, d, [(score mode, float_out)]) of _check_join_equal_plain;
# score modes as kernels.SC_*: 1 product, 2 min, 3 max, 4 sum, 5 ratio
_JOIN_RUNS = (
    ("dense_indel", True, 1, [(1, False), (2, False), (4, False)]),
    ("dense_general", True, 1, [(3, False), (5, True)]),
    ("dense_general", False, 2, [(2, False), (1, True)]),
)


def _check_join_equal_plain(d1, d2, dev, tile, runs=_JOIN_RUNS,
                            by_vjl=True):
    """Each (kernel, indels, d, modes) of runs on d1 x d2 at tile: the
    kernel launched once and equal to its plain version (int64 sums
    torch.equal, float64 sums within rtol 1e-12: atomics add in no fixed
    order), with some pair matched."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    for kernel, indels, d, modes in runs:
        wide = kernel == "dense_general"
        a, b, work = _join_inputs(d1, d2, dev, tile, indels, wide, by_vjl)
        for mode, float_out in modes:
            kw = dict(differences=d, score_mode=mode, tile_m=tile,
                      tile_n=tile, r1p=8, r2p=128)
            if wide:
                kw.update(indels=indels, float_out=float_out)
                fn, plain = K.dense_general, K.dense_general_plain
            else:
                fn, plain = K.dense_indel, K.dense_indel_plain
            before = K.LAUNCHES[kernel]
            got = fn(a, b, work, **kw)
            assert K.LAUNCHES[kernel] == before + 1
            want = plain(a, b, work, **kw)
            torch.cuda.synchronize()
            if float_out:
                torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
            else:
                assert torch.equal(got, want), (kernel, mode, indels, tile)
            assert float(want.sum()) > 0, (kernel, mode, indels, tile)


@pytest.mark.parametrize("tile", [128, 768])
@pytest.mark.parametrize("self_cmp", [False, True], ids=["two", "self"])
def test_dense_indel_kernel_equals_plain(cuda, tile, self_cmp):
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    d1, d2 = _counted(d1, 1), _counted(d2, 2)
    if self_cmp:
        d1 = d2 = _concat(d1, d2)
    a, b, work = _join_inputs(d1, d2, cuda, tile, True, False)
    for mode in (K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX, K.SC_SUM):
        kw = dict(differences=1, score_mode=mode, tile_m=tile, tile_n=tile,
                  r1p=8, r2p=128)
        before = K.LAUNCHES["dense_indel"]
        got = K.dense_indel(a, b, work, **kw)
        assert K.LAUNCHES["dense_indel"] == before + 1
        want = K.dense_indel_plain(a, b, work, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (mode, tile, self_cmp)
        assert int(want.sum()) > 0


@pytest.mark.parametrize("v_offset", [0, 1 << 15], ids=["keys", "keys64"])
@pytest.mark.parametrize("indels", [False, True], ids=["d2", "d1_indel"])
def test_dense_general_kernel_equals_plain(cuda, indels, v_offset):
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24, v_offset=v_offset)
    d1, d2 = _counted(d1, 3, 1 << 20), _counted(d2, 4, 1 << 20)
    a, b, work = _join_inputs(d1, d2, cuda, 256, indels, True)
    d = 1 if indels else 2
    for mode in (K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX, K.SC_SUM,
                 K.SC_RATIO):
        for float_out in ((True,) if mode == K.SC_RATIO else (False, True)):
            kw = dict(differences=d, indels=indels, score_mode=mode,
                      float_out=float_out, tile_m=256, tile_n=256, r1p=8,
                      r2p=128)
            before = K.LAUNCHES["dense_general"]
            got = K.dense_general(a, b, work, **kw)
            assert K.LAUNCHES["dense_general"] == before + 1
            want = K.dense_general_plain(a, b, work, **kw)
            torch.cuda.synchronize()
            if float_out:
                # float64 atomics add in no fixed order
                torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
            else:
                assert torch.equal(got, want), (mode, indels, v_offset)
            assert float(want.sum()) > 0


@pytest.mark.parametrize("case", ["indel", "min_big", "ratio"])
def test_dense_matrix_new_kernels_cuda_equals_cpu(cuda, case):
    import numpy as np

    from compairr_tpu_torch.constants import (
        SCORE_MIN,
        SCORE_PRODUCT,
        SCORE_RATIO,
    )
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix

    d1, d2 = _planted_pair(24)
    d1, d2 = _counted(d1, 5), _counted(d2, 6)
    spec = MatchSpec(differences=1, indels=case != "ratio",
                     ignore_genes=False)
    score = {"indel": SCORE_PRODUCT, "min_big": SCORE_MIN,
             "ratio": SCORE_RATIO}[case]
    kernel = "dense_indel" if case == "indel" else "dense_general"
    K.reset_launches()
    got = dense_matrix(d1, d2, spec, score, False, device="cuda")
    assert K.LAUNCHES[kernel] == 1
    want = dense_matrix(d1, d2, spec, score, False, device="cpu")
    if case == "ratio":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("lpad", [48, 136, 200])
def test_dense_join_kernels_at_every_lpad(cuda, lpad):
    """Nucleotide rows (3 planes) at lpad 48 (C = 2, compile-time C/P)
    and at 136 and 200 (C = 5 and 7: the runtime-C/P loop), both
    kernels at tile 128, two sets and a self-comparison."""
    d1, d2 = _planted_pair(lpad)
    d1, d2 = _counted(d1, 7), _counted(d2, 8)
    _check_join_equal_plain(d1, d2, cuda, 128)
    s = _concat(d1, d2)
    _check_join_equal_plain(s, s, cuda, 128, runs=_JOIN_RUNS[:1])


def test_dense_join_kernels_chunked_b_planes(cuda):
    """lpad 200 at tile 768: the b tile's planes (and reversed planes)
    pass the kernel's 64 KiB staging budget, so they go in two column
    chunks and a key window may span both."""
    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(200)
    d1, d2 = _counted(d1, 9), _counted(d2, 10)
    cp = K.plane_chunks(200) * 3
    assert 4 * cp * (768 + 1) * 2 > 64 * 1024
    _check_join_equal_plain(d1, d2, cuda, 768)


@pytest.mark.parametrize("tile", [128, 768])
def test_dense_join_kernels_g_cut(cuda, tile):
    """-g: keys by length alone, so tiles hold one or a few keys and
    every a run's window spans most of the b tile."""
    d1, d2 = _planted_pair(24)
    d1, d2 = _counted(d1, 11), _counted(d2, 12)
    _check_join_equal_plain(d1, d2, cuda, tile, by_vjl=False)


def test_dense_general_sums_past_int64(cuda):
    """Counts x 2^32 with 2^32 counts: products past 2^63 are summed in
    float64, as engine.dense_matrix asks when a cell could pass 2^62;
    keys >= 2^31 as well."""
    import numpy as np
    from dataclasses import replace

    d1, d2 = _planted_pair(24, v_offset=1 << 15)
    d1, d2 = (replace(x, counts=_counted(x, s).counts << 32)
              for x, s in ((d1, 13), (d2, 14)))
    assert int(d1.counts.max()) * int(d2.counts.max()) > np.iinfo(np.int64).max
    _check_join_equal_plain(d1, d2, cuda, 128, runs=(
        ("dense_general", True, 1, [(1, True), (4, True)]),
        ("dense_general", False, 2, [(1, True)]),
    ))


def test_dense_join_kernels_require_planes(cuda):
    """On the card both kernels read only planes: a side without them
    (or without the reversed rows' planes on an indel run) raises, with
    no fallback to the residue rows and no launch."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    a, b, work = _join_inputs(d1, d2, cuda, 128, True, False)
    wa, wb, wwork = _join_inputs(d1, d2, cuda, 128, True, True)
    kw = dict(differences=1, score_mode=K.SC_PRODUCT, tile_m=128,
              tile_n=128, r1p=8, r2p=128)

    def bare(side):
        return {k: v for k, v in side.items()
                if k not in ("planes", "rplanes")}

    before = dict(K.LAUNCHES)
    for strip in (bare, lambda side: {k: v for k, v in side.items()
                                      if k != "rplanes"}):
        with pytest.raises(ValueError, match="planes"):
            K.dense_indel(strip(a), b, work, **kw)
        with pytest.raises(ValueError, match="planes"):
            K.dense_general(wa, strip(wb), wwork, indels=True,
                            float_out=False, **kw)
    with pytest.raises(ValueError, match="planes"):
        K.dense_general(bare(wa), wb, wwork, indels=False, float_out=False,
                        **dict(kw, differences=2))
    torch.cuda.synchronize()
    assert K.LAUNCHES == before


@pytest.mark.parametrize("indels", [True, False], ids=["d1_indel", "d2"])
def test_dense_matrix_join_reads_planes_only(cuda, monkeypatch, indels):
    """dense_matrix's dense_indel / dense_general rows on the card hold
    the planes and no int8 rows, and the matrix equals the CPU's."""
    import numpy as np

    from compairr_tpu_torch.constants import SCORE_MIN, SCORE_PRODUCT
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix

    d1, d2 = _planted_pair(24)
    d1, d2 = _counted(d1, 15), _counted(d2, 16)
    rows = []
    real = K.device_args_raw

    def spy(*args, **kw):
        rows.append(real(*args, **kw))
        return rows[-1]

    monkeypatch.setattr(K, "device_args_raw", spy)
    spec = MatchSpec(differences=1 if indels else 2, indels=indels,
                     ignore_genes=False)
    score = SCORE_PRODUCT if indels else SCORE_MIN
    got = dense_matrix(d1, d2, spec, score, False, device="cuda")
    assert len(rows) == 2
    for side in rows:
        assert "seqs" not in side and "rseqs" not in side
        assert "planes" in side and ("rplanes" in side) == indels
    want = dense_matrix(d1, d2, spec, score, False, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def _onehot_inputs(d1, d2, dev, tm, tn, by_vjl=True, shuffle=False):
    """dense_onehot inputs with tiles tm x tn (each set packed at its
    own tile), and two worklists: the one from the keys and every tile
    pair of both padded row sets (pads and all-pad tiles); by_vjl=False
    keys by length alone (-g); shuffle permutes each side's rows (the
    worklist then no longer follows the keys, and every key range is
    wide)."""
    import numpy as np
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tm, by_vjl)
    ob, kb, nb = E.pack_keys(d2, tn, by_vjl)
    keyed = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, 0, tm, tn))
    every = np.array([(r, c) for r in range(0, na - tm + 1, tm)
                      for c in range(0, nb - tn + 1, tn)], dtype=np.int32)
    a = K.device_args_raw(d1, oa, na, lpad, ka, dev)
    b = K.device_args_raw(d2, ob, nb, lpad, kb, dev)
    if shuffle:
        gen = torch.Generator().manual_seed(na + nb)
        for side in (a, b):
            perm = torch.randperm(side["rep"].shape[0], generator=gen).to(dev)
            for k in ("seqs", "key32", "rep", "cnt"):
                side[k] = side[k][perm].contiguous()
    return a, b, [K.upload_worklist(w, dev) for w in (keyed, every)]


def _group_ranges(side):
    """[groups, 2] min and max key over the rows with rep >= 0 of each
    64-row group of a side, row by row; (2^31 - 1, -2^31) for a group
    without one: the ranges dense_onehot skips sub-blocks by."""
    import numpy as np

    key, rep = side["key32"].cpu().numpy(), side["rep"].cpu().numpy()
    groups = -(-len(key) // 64)
    out = np.empty((groups, 2), dtype=np.int64)
    for gi in range(groups):
        real = key[gi * 64:(gi + 1) * 64][rep[gi * 64:(gi + 1) * 64] >= 0]
        out[gi] = ((real.min(), real.max()) if len(real)
                   else (2 ** 31 - 1, -2 ** 31))
    return out


def _meeting_share(a, b, work, tm, tn, chunk=128):
    """The share of the worklist's 64-row x chunk-column sub-blocks whose
    key ranges meet, as the kernel tests them."""
    ra, rb = _group_ranges(a), _group_ranges(b)

    def rng(r, row0, n):
        g = r[row0 // 64:(row0 + n - 1) // 64 + 1]
        return g[:, 0].min(), g[:, 1].max()

    meet = total = 0
    for a0, b0 in work.cpu().numpy():
        for c0 in range(0, tn, chunk):
            blo, bhi = rng(rb, b0 + c0, min(chunk, tn - c0))
            for s0 in range(0, tm, 64):
                alo, ahi = rng(ra, a0 + s0, 64)
                total += 1
                meet += bool(alo <= ahi and blo <= bhi and alo <= bhi
                             and blo <= ahi)
    return meet / total


@pytest.mark.parametrize("tiles", [(128, 128), (64, 128), (128, 64),
                                   (768, 768)],
                         ids=["t128", "t64x128", "t128x64", "t768"])
@pytest.mark.parametrize("lpad", [24, 48, 200])
def test_dense_onehot_kernel_equals_plain(cuda, lpad, tiles):
    """Every score mode at d = 2 and product at d = 0, 1, 3, on sets
    whose last real tile is ragged (2,000 and 2,500 rows), on tiles
    whose rows and columns differ (tile_n 64: a ragged 64-column b
    chunk), over every pad row (all-pad slices and chunks), on rows
    keyed by V, J and length (key changes inside 64-row slices; at tile
    768 most sub-blocks skipped), by length alone (-g) and shuffled;
    amino acids at lpad 24, nucleotides at 48 and 200 (K past one a
    stage, narrow b chunks): the kernel equals its plain version and
    dense_match, one launch a call."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(lpad)
    d1, d2 = _counted(d1, 7), _counted(d2, 8)
    tm, tn = tiles
    cases = [(m, 2) for m in (K.SC_ONE, K.SC_PRODUCT, K.SC_MIN, K.SC_MAX,
                              K.SC_SUM)]
    cases += [(K.SC_PRODUCT, d) for d in (0, 1, 3)]
    for rows in ("vjl", "g", "shuffled"):
        a, b, works = _onehot_inputs(d1, d2, cuda, tm, tn,
                                     by_vjl=rows != "g",
                                     shuffle=rows == "shuffled")
        assert a["seqs"].shape[1] == lpad
        if rows == "vjl":
            ra = _group_ranges(a)
            assert (ra[:, 0] < ra[:, 1]).any()  # keys change in a slice
            assert (ra[:, 0] > ra[:, 1]).any()  # all-pad slices
            if tiles == (768, 768) and lpad == 24:
                assert _meeting_share(a, b, works[0], tm, tn) < 0.5
        for work in works:
            for mode, d in cases if rows == "vjl" else cases[1:2]:
                kw = dict(differences=d, score_mode=mode, tile_m=tm,
                          tile_n=tn, r1p=8, r2p=128)
                before = K.LAUNCHES["dense_onehot"]
                got = K.dense_onehot(a, b, work, **kw)
                assert K.LAUNCHES["dense_onehot"] == before + 1
                want = K.dense_onehot_plain(a, b, work, **kw)
                ref = K.dense_match_plain(a, b, work, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (rows, mode, d, tiles, lpad)
                assert torch.equal(got, ref), (rows, mode, d, tiles, lpad)
                # every planted pair carries an edit: no match at d = 0
                assert (int(want.sum()) > 0) == (d > 0)


def test_dense_onehot_launch_refuses_bad_shapes(cuda):
    """The kernel's C entry refuses tiles that are not multiples of 64
    and an lpad that is not a multiple of 4, launching nothing."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    a, b, works = _onehot_inputs(d1, d2, cuda, 128, 128)
    out = torch.zeros((8, 128), dtype=torch.int64, device=cuda)
    lib = K.load_library("dense_onehot")
    for tm, tn, lpad in ((96, 128, 24), (128, 32, 24), (0, 128, 24),
                         (128, 128, 22)):
        err = lib.dense_onehot_launch(
            a["seqs"].data_ptr(), a["key32"].data_ptr(), a["rep"].data_ptr(),
            a["cnt"].data_ptr(), b["seqs"].data_ptr(),
            b["key32"].data_ptr(), b["rep"].data_ptr(), b["cnt"].data_ptr(),
            works[0].data_ptr(), works[0].shape[0], a["seqs"].shape[0],
            b["seqs"].shape[0], tm, tn, lpad, 2, K.SC_PRODUCT, 128,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err != 0, (tm, tn, lpad)
    torch.cuda.synchronize()
    assert int(out.sum()) == 0


def test_dense_onehot_smem_fits_any_lpad(cuda):
    """The kernel's shared memory stays within a block's at any lpad
    (a stages of at most 512 lanes, b chunks narrowing as K grows)."""
    from compairr_tpu_torch.ops import kernels as K

    lib = K.load_library("dense_onehot")
    for lpad in (4, 8, 16, 24, 48, 96, 200):
        assert 0 < lib.dense_onehot_smem_bytes(lpad) <= 232448


@pytest.mark.parametrize("genes", [False, True], ids=["vj", "g"])
def test_dense_matrix_onehot_cuda_equals_cpu(cuda, monkeypatch, genes):
    """dense_matrix under COMPAIRR_V3=0 launches dense_onehot once and
    no dense_match, and equals the CPU's matrix and dense_match's."""
    import numpy as np

    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix

    d1, d2 = _planted_pair(24)
    d1, d2 = _counted(d1, 9), _counted(d2, 10)
    spec = MatchSpec(differences=2, indels=False, ignore_genes=genes)
    monkeypatch.delenv("COMPAIRR_V3", raising=False)
    ref = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False, device="cuda")
    monkeypatch.setenv("COMPAIRR_V3", "0")
    K.reset_launches()
    got = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False, device="cuda")
    assert K.LAUNCHES["dense_onehot"] == 1
    assert K.LAUNCHES["dense_match"] == 0
    want = dense_matrix(d1, d2, spec, SCORE_PRODUCT, False, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert want.sum() > 0


MODES = (0, 1, 2, 3, 4)  # SC_ONE, SC_PRODUCT, SC_MIN, SC_MAX, SC_SUM


def _lpad_pair(lpad):
    """Two planted sets (2,000 and 2,500 rows, counts 1..99) whose rows
    pad to lpad: amino acids, nucleotides at lpad 40 (3 planes)."""
    nt = lpad == 40
    lr = (lpad - 8, lpad - 2)
    d1 = _planted_db(2000, lr, 51, nt)
    d2 = _planted_db(2500, lr, 52, nt, src=d1)
    return _counted(d1, 11), _counted(d2, 12)


def _match_inputs(d1, d2, dev, tm, tn, by_vjl=True):
    """dense_match inputs with planes (each set packed at its own tile)
    and two worklists: the one from the keys and every tile pair of
    both padded row sets (all-pad tiles included)."""
    import numpy as np

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    lpad = E._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = E.pack_keys(d1, tm, by_vjl)
    ob, kb, nb = E.pack_keys(d2, tn, by_vjl)
    keyed = E.order_colmajor(
        E.worklist_from_keys(ka, d1.n, kb, d2.n, 0, tm, tn))
    every = np.array([(r, c) for r in range(0, na - tm + 1, tm)
                      for c in range(0, nb - tn + 1, tn)], dtype=np.int32)
    a = K.device_args_raw(d1, oa, na, lpad, ka, dev, planes=True)
    b = a if d2 is d1 and tm == tn else K.device_args_raw(
        d2, ob, nb, lpad, kb, dev, planes=True)
    return a, b, [K.upload_worklist(w, dev) for w in (keyed, every)]


def _check_match(a, b, works, tm, tn, ds, modes=MODES):
    """The kernel equals its plain version on every worklist, distance
    and mode, one launch a call; some pair matched."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    total = 0
    for work in works:
        for d in ds:
            for mode in modes:
                kw = dict(differences=d, score_mode=mode, tile_m=tm,
                          tile_n=tn, r1p=8, r2p=128)
                before = K.LAUNCHES["dense_match"]
                got = K.dense_match(a, b, work, **kw)
                assert K.LAUNCHES["dense_match"] == before + 1
                want = K.dense_match_plain(a, b, work, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (d, mode, tm, tn)
                total += int(want.sum())
    assert total > 0


@pytest.mark.parametrize("lpad", [24, 32, 40, 96, 136])
def test_dense_match_planes_at_every_lpad(cuda, lpad):
    """C = 1 (lpad 24, 32: bit 31 in use), 2 with 3 nucleotide planes
    (40), 3 (96) and 5 (136, the runtime-C loop); d = 0..3, every
    score mode."""
    d1, d2 = _lpad_pair(lpad)
    a, b, works = _match_inputs(d1, d2, cuda, 128, 128)
    assert tuple(a["planes"].shape[1:]) == (-(-lpad // 32),
                                            3 if lpad == 40 else 5)
    _check_match(a, b, works, 128, 128, ds=(0, 1, 2, 3))


@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (768, 768),
                                   (64, 128), (128, 64), (768, 128)],
                         ids=["t64", "t128", "t768", "t64x128", "t128x64",
                              "t768x128"])
def test_dense_match_tiles(cuda, tiles):
    tm, tn = tiles
    d1, d2 = _lpad_pair(24)
    a, b, works = _match_inputs(d1, d2, cuda, tm, tn)
    _check_match(a, b, works, tm, tn, ds=(0, 2))


@pytest.mark.parametrize("tile", [128, 768])
def test_dense_match_single_key_tiles(cuda, tile):
    """-g: keys by length alone, so most tiles are one equal-key
    rectangle."""
    d1, d2 = _lpad_pair(24)
    a, b, works = _match_inputs(d1, d2, cuda, tile, tile, by_vjl=False)
    _check_match(a, b, works, tile, tile, ds=(1, 3), modes=(1, 4))


def test_dense_match_one_row_runs(cuda):
    """Every row its own key (a self-comparison): each run is one a row
    against one b row."""
    import numpy as np
    from dataclasses import replace

    d1, _ = _lpad_pair(24)
    d1 = replace(d1, v_no=np.arange(d1.n, dtype=np.int32))
    a, b, works = _match_inputs(d1, d1, cuda, 128, 128)
    assert a is b
    _check_match(a, b, works, 128, 128, ds=(0, 2), modes=(0, 1))


def _raw_match(a, b, work, tm, tn, d, mode):
    """The C launch itself, without the wrapper's checks (which admit
    only tiles inside both row sets): int64 [8, 128]."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    lib = K.load_library("dense_match")
    out = torch.zeros((8, 128), dtype=torch.int64, device=work.device)
    n_chunks, n_planes = a["planes"].shape[1:]
    err = lib.dense_match_launch(
        a["planes"].data_ptr(), a["key32"].data_ptr(), a["rep"].data_ptr(),
        a["cnt"].data_ptr(), b["planes"].data_ptr(), b["key32"].data_ptr(),
        b["rep"].data_ptr(), b["cnt"].data_ptr(), work.data_ptr(),
        work.shape[0], a["seqs"].shape[0], b["seqs"].shape[0], tm, tn,
        n_chunks, n_planes, d, mode, 128, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.dense_match_error_string(err)
    return out


def _with_pad_rows(side, n, pad):
    """side's rows followed by n pad rows (pad residues and their
    planes, key -1, rep -1, count 0)."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    seqs = torch.full((n, side["seqs"].shape[1]), pad, dtype=torch.int8,
                      device=side["seqs"].device)
    tail = {"seqs": seqs,
            "planes": K.residue_planes(seqs, side["planes"].shape[2]),
            "key32": torch.full_like(side["key32"][:n], -1),
            "rep": torch.full_like(side["rep"][:n], -1),
            "cnt": torch.zeros_like(side["cnt"][:n])}
    return {k: torch.cat([side[k], v]) for k, v in tail.items()}


def test_dense_match_ragged_tiles_and_negative_starts(cuda):
    """Tiles that run past the end of a row set (the kernel clips them),
    overlapping tiles, pads-only tails and worklist rows with -1 starts
    (skipped): the kernel equals the plain version on the row sets
    extended by pad rows, over the rows with real starts."""
    import numpy as np
    import torch

    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _lpad_pair(24)
    tm, tn = 64, 128
    a, b, _ = _match_inputs(d1, d2, cuda, tm, tn)
    na, nb = a["seqs"].shape[0], b["seqs"].shape[0]
    starts = [(r, c) for r in range(0, na, 48) for c in range(0, nb, 80)]
    skipped = [(-1, 0), (0, -1), (-1, -1), (na, 0), (0, nb)]
    work = torch.tensor(starts + skipped, dtype=torch.int32, device=cuda)
    real = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ea, eb = _with_pad_rows(a, tm, 20), _with_pad_rows(b, tn, 20)
    for d, mode in ((0, 1), (2, 1), (2, 4), (3, 2)):
        got = _raw_match(a, b, work, tm, tn, d, mode)
        want = K.dense_match_plain(ea, eb, real, differences=d,
                                   score_mode=mode, tile_m=tm, tile_n=tn,
                                   r1p=8, r2p=128)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (d, mode)
        assert (int(want.sum()) > 0) == (d > 0)
    assert any(r + tm > na for r, _ in starts)
    assert np.all(np.array(starts) >= 0)


def test_dense_match_smem_and_launch_status(cuda, sets, monkeypatch):
    """Shared memory fits a block at tile 768 for every C the tests use;
    the C launch refuses more than 5 planes; the wrapper raises on a
    non-zero launch status."""
    import torch

    from compairr_tpu_torch.ops import kernels as K

    lib = K.load_library("dense_match")
    for n_chunks in (1, 2, 3, 4, 5):
        for n_planes in (3, 5):
            assert 0 < lib.dense_match_smem_bytes(
                768, 768, n_chunks, n_planes) <= 232448
    a, b, work = _inputs(sets, cuda, 128)
    assert lib.dense_match_launch(
        *[0] * 9, 1, 128, 128, 128, 128, 1, 6, 1, 1, 128, 0, 0) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def dense_match_launch(*args):
            return 1

    monkeypatch.setattr(K, "load_library", lambda name: Refusing())
    with pytest.raises(RuntimeError):
        K.dense_match(a, b, work, differences=1, score_mode=K.SC_PRODUCT,
                      tile_m=128, tile_n=128, r1p=8, r2p=128)
    torch.cuda.synchronize()


def test_dense_match_rejects_cpu_worklist(cuda, sets):
    from compairr_tpu_torch.ops import kernels as K

    a, b, work = _inputs(sets, cuda, 128)
    with pytest.raises(ValueError):
        K.dense_match(a, b, work.cpu(), differences=1,
                      score_mode=K.SC_PRODUCT, tile_m=128, tile_n=128,
                      r1p=8, r2p=128)


def _with_reps(db, seed, n_reps=5):
    """db with its rows spread over n_reps repertoires."""
    import numpy as np
    from dataclasses import replace

    rng = np.random.default_rng(seed)
    return replace(db, rep_no=rng.integers(0, n_reps, db.n).astype(np.int32),
                   repertoire_ids=[f"R{r}" for r in range(n_reps)])


# case: (d, indels, score, COMPAIRR_V3, the kernel every shard launches)
_SHARD_RUNS = {
    "dense_match": (2, False, "product", "1", "dense_match"),
    "dense_onehot": (2, False, "product", "0", "dense_onehot"),
    "dense_indel": (1, True, "product", "1", "dense_indel"),
    "dense_general_min": (1, True, "min", "1", "dense_general"),
    "dense_general_ratio": (2, False, "ratio", "1", "dense_general"),
}


@pytest.mark.parametrize("case", list(_SHARD_RUNS))
def test_dense_sharded_cuda_equals_single(cuda, monkeypatch, case):
    """dense_matrix_sharded and dense_matrix_ring over [cuda:0] * 3 equal
    dense_matrix on the card (ratio, float64 in another order: rtol
    1e-12), each shard with work launching the run's kernel once."""
    import numpy as np
    import torch

    from compairr_tpu_torch.constants import (
        SCORE_MIN,
        SCORE_PRODUCT,
        SCORE_RATIO,
    )
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.ops.engine import MatchSpec, dense_matrix
    from compairr_tpu_torch.parallel import mesh

    d, indels, score, v3, kernel = _SHARD_RUNS[case]
    score = {"product": SCORE_PRODUCT, "min": SCORE_MIN,
             "ratio": SCORE_RATIO}[score]
    d1, d2 = _planted_pair(24)
    d1 = _with_reps(_counted(d1, 5), 7)
    d2 = _with_reps(_counted(d2, 6), 8, 6)
    spec = MatchSpec(differences=d, indels=indels, ignore_genes=False)
    monkeypatch.setenv("COMPAIRR_V3", v3)
    want = dense_matrix(d1, d2, spec, score, False, device="cuda")
    devs = [torch.device("cuda", 0)] * 3
    for run in (mesh.dense_matrix_sharded, mesh.dense_matrix_ring):
        K.reset_launches()
        got = run(d1, d2, spec, score, False, devices=devs)
        assert K.LAUNCHES[kernel] >= 3, (run.__name__, dict(K.LAUNCHES))
        # the run's kernel and the derives alone (derive_rows, a set and
        # shard at least)
        assert K.LAUNCHES["derive_rows"] >= 2, dict(K.LAUNCHES)
        assert sum(K.LAUNCHES.values()) == (K.LAUNCHES[kernel]
                                            + K.LAUNCHES["derive_rows"])
        if case.endswith("ratio"):
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)
    assert sum(1 for t in mesh.LAST_STATS.get("real_tiles", [1]) if t) >= 1
    assert want.sum() > 0 and want.shape == (5, 6)


def test_find_pairs_device_split_cuda_equals_one_device(cuda, monkeypatch):
    """find_pairs -d 1 -i over [cuda:0] * 3 (each class stream in 3
    spans) returns one device's pairs."""
    import numpy as np
    import torch

    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    d1, d2 = _planted_pair(24)
    spec = E.MatchSpec(1, True, False)
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(E, "TILES_PER_DEVICE_MIN", 1)
    K.reset_launches()
    want = E.find_pairs(d1, d2, spec, devices=[dev])
    one = K.LAUNCHES["count_tiles"]
    K.reset_launches()
    got = E.find_pairs(d1, d2, spec, devices=[dev] * 3)
    assert K.LAUNCHES["count_tiles"] > one >= 1
    assert K.LAUNCHES["extract_tiles"] >= 1

    def key(r):
        o = np.lexsort((r[1], r[0]))
        return r[0][o], r[1][o]

    for g, w in zip(key(got), key(want)):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > 0


@pytest.mark.parametrize("mode", [None, "0"], ids=["default", "tiles"])
def test_substitution_route_on_the_card(cuda, monkeypatch, mode):
    """A -d 2 run of 200,000 rows a set, no device named, with the card
    already started: by default (engine.card_route) it stays on the
    host pigeonhole and launches nothing; under COMPAIRR_PIGEONHOLE=0 it
    takes the tile route at 512-row tiles and launches count_tiles and
    extract_tiles. Both give the pairs of COMPAIRR_PIGEONHOLE=all."""
    import numpy as np
    import torch

    from compairr_tpu_torch.bench import kernel_sets
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    if mode is None:
        monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    else:
        monkeypatch.setenv("COMPAIRR_PIGEONHOLE", mode)
    d1, d2 = kernel_sets(200_000)
    spec = E.MatchSpec(2, False, False)
    torch.zeros(1, device=cuda)  # the card started changes no route
    K.reset_launches()
    got = E.find_pairs(d1, d2, spec, want_dist=False)
    launches = dict(K.LAUNCHES)
    if mode == "0":
        assert E.LAST_ROUTE == "tiles" and E.LAST_TILE == 512
        assert launches["count_tiles"] >= 1 and launches["extract_tiles"] >= 1
    else:
        assert E.LAST_ROUTE == "pigeonhole"
        assert sum(launches.values()) == 0, launches
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    want = E.find_pairs(d1, d2, spec, want_dist=False)
    assert E.LAST_ROUTE == "pigeonhole"

    def key(r):
        o = np.lexsort((r[1], r[0]))
        return r[0][o], r[1][o]

    for g, w in zip(key(got), key(want)):
        np.testing.assert_array_equal(g, w)
    assert len(want[0]) > 0


@pytest.mark.parametrize("planted", [False, True])
def test_entry_on_card_equals_dense_span(cuda, planted):
    """The entry point on the card: one dense_match launch, its
    raw sums equal to engine.dense_span's on the same plan; on the
    planted sets the sums are not all zero."""
    import torch

    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.graft_entry import _entry_dbs, entry
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K

    step, args = entry(cuda, planted=planted)
    before = K.LAUNCHES["dense_match"]
    out = step(*args)
    assert K.LAUNCHES["dense_match"] == before + 1
    d1, d2 = _entry_dbs(planted)
    plan = E.dense_plan(d1, d2, E.MatchSpec(2, False, False), SCORE_PRODUCT,
                        False)
    want = E.dense_span(
        plan,
        E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a, cuda),
        E.dense_side(plan, d2, plan.order_b, plan.key_b, plan.npad_b, cuda))
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and torch.equal(out, want)
    assert (int(out.sum()) > 0) == planted


def test_bench_kernel_section_on_card(cuda, monkeypatch):
    """The bench's kernel section at a cut size: its checksum equals
    dense_matrix's on the same sets, its wall is no shorter than its
    bound, and it names the card."""
    import torch

    from compairr_tpu_torch import bench
    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.ops import engine as E

    monkeypatch.setenv("COMPAIRR_BENCH_NK", "100000")
    monkeypatch.setenv("COMPAIRR_BENCH_KERNEL_REPS", "2")
    km = bench._kernel_metrics(768, cuda)
    d1, d2 = bench.kernel_sets(100_000)
    want = E.dense_matrix(d1, d2, E.MatchSpec(2, False, False),
                          SCORE_PRODUCT, False, tile_m=768, tile_n=768,
                          device=cuda)
    assert want.sum() > 0 and km["kernel_checksum"] == float(want.sum())
    assert km["device_kind"] == torch.cuda.get_device_name(cuda)
    assert 0 < km["kernel_bound_s"] <= km["kernel_wall_s"]


def test_traced_cli_job_on_the_card(cuda, monkeypatch, tmp_path):
    """A -m -d 1 -i CLI job under COMPAIRR_TIMING=1 on the card: the
    derive's and the count's uploads count their bytes on their laps
    (engine.rows_raw, engine.count), the derive its one derive_rows
    launch, every extract span (one a class) its worklist's and offsets'
    upload and its error flag's copy-back, the one decode span the
    pairs' copy-back, and the job counts its kernel library loads."""
    from compairr_tpu_torch import cli
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils import trace
    from synth import make_tsv

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    monkeypatch.setattr(K, "_LIBS", {})
    a = make_tsv(str(tmp_path / "a.tsv"), 20_000, 5, seed=41,
                 alphabet_sub=3, n_v=2, n_j=2, len_range=(6, 9),
                 max_count=3)
    trace.reset()
    try:
        assert cli.main(["-m", "-d", "1", "-i", a, a,
                         "-o", str(tmp_path / "o.tsv")]) == 0
        spans = trace.spans()
    finally:
        trace.reset()
        monkeypatch.delenv("COMPAIRR_TIMING")
        trace.refresh()
    by: dict = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (job,) = by["job"]
    # derive_rows and tile_match, and airr_parse where the parse took the
    # card route
    parses = by["io.parse"]
    assert job.counts["kernel_loads"] == 2 + any(
        s.counts["route"] == "card" for s in parses)
    # a self-comparison shares one derive: one derive_rows launch
    (derive,) = by["engine.rows_raw"]
    assert derive.counts["derive_launches"] == 1
    (fp,) = by["engine.find_pairs"]
    assert fp.counts["route"] == "tiles" and fp.counts["tile"] == 512
    for name in ("engine.rows_raw", "engine.count", "kernels.extract"):
        for s in by[name]:
            assert s.counts["upload_bytes"] > 0, name
    (cnt,) = by["engine.count"]
    assert 0 < cnt.counts["tiles_matched"] <= cnt.counts["tiles"]
    extracts = by["kernels.extract"]
    assert 1 <= len(extracts) <= len(K.CLASS_NAMES)
    for s in extracts:
        assert s.counts["d2h_bytes"] == 4
        assert s.counts["upload_bytes"] == 16 * s.counts["tiles"]
    assert sum(s.counts["tiles"] for s in extracts) \
        == cnt.counts["tiles_matched"]
    (decode,) = by["engine.decode"]
    pairs = sum(s.counts["pairs"] for s in extracts)
    assert decode.counts["pairs"] == pairs > 0
    assert decode.counts["d2h_bytes"] == 8 * pairs


# --------------------------------------------------------------------
# airr_parse: the card route of read_db (io/card.py)
# --------------------------------------------------------------------


def _native_parser(monkeypatch):
    """The native parser, built here when absent (the card's machine
    starts with no build)."""
    import subprocess

    from compairr_tpu_torch.io import native

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if native.load_library() is None:
        subprocess.run(["make", "-C", os.path.join(root, "native")],
                       check=True, stdout=subprocess.DEVNULL)
        monkeypatch.setattr(native, "_TRIED", False)
    lib = native.load_library()
    assert lib is not None
    return lib


@pytest.fixture(scope="module")
def keck_cut(tmp_path_factory):
    """A 200,000-row cut of the benchmark's keck20 cohort (its generator
    and parameters, rows reduced), as a TSV."""
    import json

    from portbench import gen

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "keck20.json")) as f:
        cfg = json.load(f)
    p = dict(cfg["sets"]["cohort"], rows=200_000)
    sets = gen.make_sets({"sets": {"cohort": p}}, 2_718_281_828)
    path = str(tmp_path_factory.mktemp("keck") / "cohort.tsv")
    gen.write_tsv(sets["cohort"], p["columns"], path)
    return path


@pytest.fixture(scope="module")
def keck_cut_ignored(tmp_path_factory, keck_cut):
    """The keck20 cut with rows that -u and -e ignore: a stop codon ('*')
    in every 37th row's junction, two in every 1,009th, and every 101st
    junction empty."""
    path = str(tmp_path_factory.mktemp("keck_u") / "cohort_ue.tsv")
    with open(keck_cut) as f, open(path, "w") as g:
        g.write(f.readline())
        for i, line in enumerate(f):
            head, _, seq = line.rstrip("\n").rpartition("\t")
            if i % 101 == 0:
                seq = ""
            elif i % 1009 == 0:
                seq = seq[:2] + "*" + seq[2:] + "*"
            elif i % 37 == 0:
                seq = seq[:3] + "*" + seq[3:]
            g.write(f"{head}\t{seq}\n")
    return path


def _same_db(a, b, native=False):
    import numpy as np

    for k in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("repertoire_ids", "residues_count", "total_dup_count",
              "shortest", "longest", "ignored_unknown", "ignored_empty"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.genes.v_names == b.genes.v_names
    assert a.genes.j_names == b.genes.j_names
    assert np.array_equal(a.row_hash, b.row_hash)
    for k in ("_blob", "_off", "_has"):
        x = np.asarray(getattr(a.sequence_ids, k))
        y = np.asarray(getattr(b.sequence_ids, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _card_read(path, opt, dev, require_sid=False, default="1"):
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io import card
    from compairr_tpu_torch.utils.progress import NullLogger

    return card.read_db_card(path, opt, GeneTables(), NullLogger(),
                             require_sid, default, dev)


def test_airr_scan_equals_plain(cuda, keck_cut):
    """The kernels' scan of the keck20 cut against the plain version's,
    array by array, and the launches counted."""
    import numpy as np
    import torch

    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.io import card
    from compairr_tpu_torch.ops import kernels as K

    cols, off = card._header(keck_cut, Options(), False)
    n_bytes = os.path.getsize(keck_cut) - off
    spec = K.AirrSpec(cols=cols, nucleotides=False, ignore_counts=False,
                      ignore_genes=False, require_sid=False,
                      def_off=n_bytes + (-n_bytes % 16), def_len=1)
    host = card._upload(torch, keck_cut, off, n_bytes, b"1",
                        torch.device("cpu"))
    dev = card._upload(torch, keck_cut, off, n_bytes, b"1", cuda)
    assert torch.equal(dev.cpu(), host)
    before = dict(K.LAUNCHES)
    got = K.airr_scan(dev, n_bytes, spec)
    want = K.airr_scan(host, n_bytes, spec)
    assert K.LAUNCHES["airr_lines"] == before["airr_lines"] + 2
    assert K.LAUNCHES["airr_verify"] == before["airr_verify"] + 1
    for k in ("lines", "n", "flagged", "collisions", "longest", "shortest",
              "total_dup", "residues", "ignored", "ignored_unknown",
              "ignored_empty"):
        assert got[k] == want[k], k
    assert got["n"] == 200_000 and got["flagged"] == 0
    for k in ("starts", "lengths", "counts", "row_hash", "seq_off"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("firsts", "tok_off", "tok_len"):
        for x, y in zip(got[k], want[k]):
            assert np.array_equal(x, y), k
    ids = [np.arange(len(f), dtype=np.int32) for f in got["firsts"]]
    assert torch.equal(K.airr_pack(dev, got, got["longest"], 20).cpu(),
                       K.airr_pack(host, want, want["longest"], 20))
    assert torch.equal(K.airr_ids(got, ids).cpu(), K.airr_ids(want, ids))


def test_card_parse_equals_plain_and_native(cuda, monkeypatch, keck_cut):
    """read_db's card route on the keck20 cut against the plain version
    and the native parser: every array, row hash, name order and the
    sequence_id table."""
    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io import airr
    from compairr_tpu_torch.utils.progress import NullLogger

    import torch

    _native_parser(monkeypatch)
    got, why = _card_read(keck_cut, Options(), cuda)
    assert why is None
    plain, _ = _card_read(keck_cut, Options(), torch.device("cpu"))
    _same_db(got, plain)
    monkeypatch.setattr("compairr_tpu_torch.io.card.card_device",
                        lambda *a: None)
    native = airr.read_db(keck_cut, Options(), GeneTables(), NullLogger(),
                          False, "1")
    _same_db(got, native)


def test_card_parse_ignored_rows(cuda, monkeypatch, keck_cut_ignored):
    """The keck20 cut with rows ignored under -u and -e, on the card:
    the kept rows compacted, and every array and count equal to the
    plain version's and the native parser's."""
    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io import airr
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils.progress import NullLogger

    import torch

    _native_parser(monkeypatch)
    opt = Options(ignore_unknown=True, ignore_empty=True)
    before = K.LAUNCHES["airr_compact"]
    got, why = _card_read(keck_cut_ignored, opt, cuda)
    assert why is None and K.LAUNCHES["airr_compact"] == before + 1
    assert got.ignored_unknown > got.ignored_empty > 0
    assert got.n == sum(1 for i in range(200_000)
                        if i % 101 and i % 1009 and i % 37)
    plain, _ = _card_read(keck_cut_ignored, opt, torch.device("cpu"))
    _same_db(got, plain)
    monkeypatch.setattr("compairr_tpu_torch.io.card.card_device",
                        lambda *a: None)
    native = airr.read_db(keck_cut_ignored, opt, GeneTables(), NullLogger(),
                          False, "1")
    _same_db(got, native)


def test_card_parse_edge_cases(cuda, monkeypatch, tmp_path):
    """The tier-1 edge-case files (tests/test_torch_card_parse.py) on
    the card against the native parser, one GeneTables a case; and every
    flagged kind and a planted collision leave the card route."""
    import test_torch_card_parse as T

    from compairr_tpu_torch.config import Options
    from compairr_tpu_torch.core.db import GeneTables
    from compairr_tpu_torch.io import airr, card
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils.progress import NullLogger

    _native_parser(monkeypatch)
    for name, (texts, kw, require_sid, default) in sorted(T.CASES.items()):
        paths = T._write(tmp_path, texts)
        opt = Options(**kw)
        g1, g2 = GeneTables(), GeneTables()
        for path in paths:
            got, why = card.read_db_card(path, opt, g1, NullLogger(),
                                         require_sid, default, cuda)
            assert why is None, name
            with monkeypatch.context() as m:
                m.setattr(card, "card_device", lambda *a: None)
                want = airr.read_db(path, opt, g2, NullLogger(), require_sid,
                                    default)
            _same_db(got, want)
    for name, (row, kw, require_sid) in sorted(T.BAD.items()):
        if row is None:
            continue
        path = tmp_path / f"bad_{name}.tsv"
        path.write_bytes(T._tsv(T.H, T.ROWS + [row]).encode("latin-1"))
        got, why = _card_read(str(path), Options(**kw), cuda, require_sid)
        if name in T.IGNORED:
            assert why is None, name
            with monkeypatch.context() as m:
                m.setattr(card, "card_device", lambda *a: None)
                want = airr.read_db(str(path), Options(**kw), GeneTables(),
                                    NullLogger(), require_sid, "1")
            _same_db(got, want)
        else:
            assert (got, why) == (None, "flagged_row"), name
    path = tmp_path / "ok.tsv"
    path.write_text(T._tsv(T.H, T.ROWS))
    with monkeypatch.context() as m:
        m.setattr(card, "card_device", lambda *a: None)
        want = airr.read_db(str(path), Options(), GeneTables(), NullLogger(),
                            False, "1")
    monkeypatch.setattr(K, "AIRR_KEY_MASKS", (0, -1))
    got, why = _card_read(str(path), Options(), cuda)
    assert why is None
    _same_db(got, want)
    monkeypatch.setattr(K, "AIRR_KEY_MASKS", (0, 0, 0))
    assert _card_read(str(path), Options(), cuda) == (None, "collision")


def test_cli_job_same_output_on_both_routes(cuda, monkeypatch, tmp_path,
                                            keck_cut):
    """One -m -d 1 -i CLI job on the keck20 cut: the card route's output
    file is the host route's, byte for byte; the span says which route
    each read took."""
    import torch

    from compairr_tpu_torch import cli
    from compairr_tpu_torch.io import card
    from compairr_tpu_torch.utils import trace

    _native_parser(monkeypatch)
    torch.zeros(1, device=cuda)  # CUDA started: the warm crossover
    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    outs, routes = [], []
    try:
        for host in (False, True):
            if host:
                monkeypatch.setattr(card, "card_device", lambda *a: None)
            out = tmp_path / f"o{int(host)}.tsv"
            trace.reset()
            assert cli.main(["-m", "-d", "1", "-i", keck_cut,
                             "-o", str(out)]) == 0
            routes.append([s.counts["route"] for s in trace.spans()
                           if s.name == "io.parse"])
            outs.append(out.read_bytes())
    finally:
        trace.reset()
        monkeypatch.delenv("COMPAIRR_TIMING")
        trace.refresh()
    assert routes == [["card"], ["host"]]
    assert outs[0] == outs[1] and len(outs[0]) > 0
