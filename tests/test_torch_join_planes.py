"""The residue bit planes that dense_indel and dense_general read on the
card (csrc/dense_general.cu; compairr_tpu_torch.ops.kernels.device_args_raw
with planes), on the CPU:

  * the derive against a numpy bit-by-bit reference of the key-sorted
    rows and of the rows reversed within their lengths, at every chunk
    count the kernels distinguish (lpad 8 to 136), for amino acids (5
    planes) and nucleotides (3), narrow (int32) and wide (int64, keys
    >= 2^31) rows, with pad rows (key -1) and bit 31 set;
  * where the engine asks for planes: per kernel kind, on CUDA only for
    dense_indel and dense_general, whose int8 rows it then drops (the
    device monkeypatched), dense_match as before;
  * the wrappers' plane checks: a CUDA call needs planes (and rplanes on
    indel runs); on the CPU they are checked where present and the plain
    version runs on the residue rows;
  * the kernels' pair test written on planes in PyTorch (Hamming from
    popcounts; prefix and suffix from the lowest set bit of the first
    nonzero chunk mask, unclamped as the kernel takes them) equals
    _dense_join_plain's matrix on dense-derive rows, scores and pads
    included.

Integer sums are compared exactly; float64 ratio sums within rtol 1e-12
(the same scores added in another order)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from compairr_tpu_torch.constants import (
    SCORE_MAX,
    SCORE_MIN,
    SCORE_PRODUCT,
)
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K
from compairr_tpu_torch.utils import device as tdevice

from test_torch_tile_planes import (
    _db,
    _first_mismatch,
    _masks,
    _planes_ref,
    _popc,
)

LPADS = [8, 24, 32, 40, 96, 136]  # C = 1, 1, 1, 2, 3, 5
ALPHABETS = [("aa", False), ("nt", True)]
WIDTHS = [("narrow", False), ("wide", True)]


def _dense_db(n, lpad, nt, seed, src=None, wide=False, short=False):
    """test_torch_tile_planes' set with counts 1..199 and 3 repertoires;
    wide: every V index raised by 2^15, so every key is >= 2^31 (src's
    own raised V indices are lowered first, so that its planted copies
    keep their keys)."""
    shift = (1 << 15) if wide else 0
    if src is not None:
        src = replace(src, v_no=src.v_no - shift)
    db = _db(n, lpad, nt, seed, src=src, short=short)
    rng = np.random.default_rng(seed + 100)
    return replace(
        db, counts=rng.integers(1, 200, n).astype(np.int64),
        rep_no=rng.integers(0, 3, n).astype(np.int32),
        repertoire_ids=["R0", "R1", "R2"], v_no=db.v_no + shift,
    )


def _rows(db, lpad, tile, indels, wide, by_vjl=True, **kw):
    order, key, npad = teng.pack_keys(db, tile, by_vjl)
    rows = K.device_args_raw(db, order, npad, lpad, key, "cpu",
                             indels=indels, wide=wide, **kw)
    return rows, order, key


# ---- the derive ---------------------------------------------------------

@pytest.mark.parametrize("width,wide", WIDTHS, ids=[w for w, _ in WIDTHS])
@pytest.mark.parametrize("alpha,nt", ALPHABETS, ids=[a for a, _ in ALPHABETS])
@pytest.mark.parametrize("lpad", LPADS)
def test_device_args_raw_planes_match_bitwise_reference(lpad, alpha, nt,
                                                        width, wide):
    """planes and rplanes of device_args_raw against numpy, from the
    SeqDB itself: its rows in key order, pad rows (key -1) all pad, each
    row reversed within its length; without indels, planes alone."""
    db = _dense_db(90, lpad, nt, seed=lpad, wide=wide)
    rows, order, key = _rows(db, lpad, 64, True, wide, planes=True)
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
    keys = rows["key64" if wide else "key32"].numpy()
    assert npad > db.n and (keys[db.n :] == -1).all()  # pad rows checked
    assert (int(keys[: db.n].min()) >= 1 << 31) == wide
    if lpad >= 32:
        assert (rows["planes"].numpy() < 0).any()  # bit 31 in use
    only_fwd, _, _ = _rows(db, lpad, 64, False, wide, planes=True)
    assert "rplanes" not in only_fwd and "rseqs" not in only_fwd
    assert torch.equal(only_fwd["planes"], rows["planes"])


# ---- where the engine asks for planes ------------------------------------

class _Stop(Exception):
    """Raised on a monkeypatched card where the worklist would go to a
    device this host lacks: the run stops once its rows are derived."""


# (indels, d, score, count high, COMPAIRR_V3) -> the kernel that runs
KIND_CASES = {
    "dense_match": (False, 2, SCORE_PRODUCT, 50, None),
    "dense_onehot": (False, 2, SCORE_PRODUCT, 50, "0"),
    "dense_indel": (True, 1, SCORE_PRODUCT, 50, None),
    "dense_general": (False, 2, SCORE_MIN, 200, None),
    "dense_general_indel": (True, 1, SCORE_MAX, 200, None),
}


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "cuda"])
@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_dense_matrix_asks_for_planes_per_kind(monkeypatch, case, on_card):
    """dense_match asks for planes (and keeps its int8 rows) wherever it
    runs; dense_indel and dense_general ask for planes on the card, and
    drop their int8 rows there, and for no planes on the CPU;
    dense_onehot for none. On the monkeypatched card the rows are
    derived on the CPU and the run stops at the worklist's upload."""
    indels, d, score, high, v3 = KIND_CASES[case]
    kind = "dense_general" if case.startswith("dense_general") else case
    d1 = _dense_db(120, 24, False, seed=3)
    d2 = _dense_db(150, 24, False, seed=4, src=d1)
    d1, d2 = (replace(x, counts=np.minimum(x.counts, high)) for x in (d1, d2))
    if v3 is None:
        monkeypatch.delenv("COMPAIRR_V3", raising=False)
    else:
        monkeypatch.setenv("COMPAIRR_V3", v3)
    asked, sides, kinds = [], [], []
    real_rows, real_kind = K.device_args_raw, K._dense_kernel_kind

    def spy_rows(db, order, npad, lpad, key, device, **kw):
        asked.append(kw.get("planes", False))
        sides.append(real_rows(db, order, npad, lpad, key, "cpu", **kw))
        return sides[-1]

    def stop(*args, **kw):
        raise _Stop

    def spy_kind(**kw):
        kinds.append(real_kind(**kw))
        return kinds[-1]

    monkeypatch.setattr(K, "device_args_raw", spy_rows)
    monkeypatch.setattr(K, "_dense_kernel_kind", spy_kind)
    if on_card:
        monkeypatch.setattr(tdevice, "resolve_device",
                            lambda device=None: torch.device("cuda"))
        monkeypatch.setattr(K, "upload_worklist", stop)
    spec = teng.MatchSpec(differences=d, indels=indels, ignore_genes=False)
    try:
        teng.dense_matrix(d1, d2, spec, score, False,
                          device=None if on_card else "cpu")
    except _Stop:
        assert on_card
    assert kinds == [kind]
    planes_only = on_card and kind in ("dense_indel", "dense_general")
    assert asked == [kind == "dense_match" or planes_only] * 2
    for side in sides:
        assert ("seqs" in side) != planes_only
        assert ("rseqs" in side) == (indels and not planes_only)
        assert ("rplanes" in side) == (indels and planes_only)


# ---- the wrappers' plane checks -----------------------------------------

@pytest.fixture(scope="module")
def join_rows():
    """dense_indel rows (int32) and dense_general rows (int64, indels) of
    two planted sets at lpad 24, with planes, and their worklist."""
    d1 = _dense_db(160, 24, False, seed=5)
    d2 = _dense_db(200, 24, False, seed=6, src=d1)
    out = {}
    for wide in (False, True):
        a, _, ka = _rows(d1, 24, 32, True, wide, planes=True)
        b, _, kb = _rows(d2, 24, 32, True, wide, planes=True)
        work = teng.order_colmajor(
            teng.worklist_from_keys(ka, d1.n, kb, d2.n, 1, 32, 32))
        out[wide] = (a, b, K.upload_worklist(work, "cpu"))
    return out


def _without(side, *keys):
    return {k: v for k, v in side.items() if k not in keys}


@pytest.mark.parametrize("missing", ["planes", "rplanes"])
@pytest.mark.parametrize("wide", [False, True], ids=["indel", "general"])
def test_cuda_join_call_needs_planes(join_rows, wide, missing):
    """The check a CUDA call makes (_check_plane_pair on a card device):
    a side without planes, or without rplanes on an indel run, raises
    naming them; with both present only the device differs."""
    a, b, _ = join_rows[wide]
    cuda = torch.device("cuda")
    for bad_a in (True, False):
        x, y = (_without(a, missing), b) if bad_a else (a, _without(b, missing))
        with pytest.raises(ValueError, match=rf"\['{missing}'\] must be"):
            K._check_plane_pair(x, y, cuda, True)
    with pytest.raises(ValueError, match="is on cpu, expected cuda"):
        K._check_plane_pair(a, b, cuda, True)
    # a Hamming-only run reads no rplanes
    with pytest.raises(ValueError, match="is on cpu, expected cuda"):
        K._check_plane_pair(_without(a, "rplanes"), b, cuda, False)


def _join(a, b, work, wide, mode=K.SC_PRODUCT, **kw):
    args = dict(differences=1, score_mode=mode, tile_m=32, tile_n=32,
                r1p=8, r2p=128)
    if wide:
        return K.dense_general(a, b, work, indels=True, float_out=False,
                               **args, **kw)
    return K.dense_indel(a, b, work, **args, **kw)


@pytest.mark.parametrize("wide", [False, True], ids=["indel", "general"])
def test_cpu_join_checks_planes_where_present(join_rows, wide):
    """On the CPU the plain version runs on the residue rows, with or
    without planes; planes that are present are checked, and a side
    without its int8 rows cannot run there."""
    a, b, work = join_rows[wide]
    with_planes = _join(a, b, work, wide)
    bare = [_without(s, "planes", "rplanes") for s in (a, b)]
    assert torch.equal(with_planes, _join(*bare, work, wide))
    assert int(with_planes.sum()) > 0
    bad = [
        dict(a, rplanes=a["rplanes"][:, :, :3].contiguous()),
        dict(a, planes=a["planes"].long()),
        _without(a, "rplanes"),
        dict(a, planes=a["planes"][:-1].contiguous(),
             rplanes=a["rplanes"][:-1].contiguous()),
    ]
    for side in bad:
        with pytest.raises(ValueError, match="planes"):
            _join(side, b, work, wide)
    with pytest.raises(ValueError, match="seqs"):
        _join(_without(a, "seqs", "rseqs"), b, work, wide)


# ---- the pair test on planes ----------------------------------------------

def _plane_join(a, b, work, *, key, cnt, indels, differences, score_mode,
                out_dtype, tile_m, tile_n, r1p, r2p):
    """csrc/dense_general.cu's function written on planes in PyTorch:
    Hamming on equal keys (popcount of OR_q (A_q ^ B_q)), with indels the
    indel test on keys 1 apart (prefix and suffix from the first nonzero
    chunk mask, 32 C when none: no clamp to lpad), rep >= 0 on both
    sides, the score summed into [r1p, r2p]."""
    n_chunks = a["planes"].shape[1]
    ra = work[:, :1].long() + torch.arange(tile_m)
    cb = work[:, 1:].long() + torch.arange(tile_n)
    ka = a[key][ra].long()[:, :, None]
    kb = b[key][cb].long()[:, None, :]
    fwd = _masks(a["planes"][ra][:, :, None], b["planes"][cb][:, None])
    hit = (ka == kb) & (_popc(fwd).sum(-1) <= differences)
    if indels:
        rev = _masks(a["rplanes"][ra][:, :, None], b["rplanes"][cb][:, None])
        pre = _first_mismatch(fwd, 32 * n_chunks)
        suf = _first_mismatch(rev, 32 * n_chunks)
        minlen = torch.minimum(ka & 0xFFFF, kb & 0xFFFF)
        hit |= ((ka - kb).abs() == 1) & (pre + suf >= minlen)
    rep_a, rep_b = a["rep"][ra].long(), b["rep"][cb].long()
    hit &= (rep_a >= 0)[:, :, None] & (rep_b >= 0)[:, None, :]
    t, i, j = hit.nonzero(as_tuple=True)
    score = K._pair_score(score_mode, a[cnt][ra[t, i]].to(out_dtype),
                          b[cnt][cb[t, j]].to(out_dtype))
    out = torch.zeros(r1p * r2p, dtype=out_dtype)
    out.index_put_((rep_a[t, i] * r2p + rep_b[t, j],), score,
                   accumulate=True)
    return out.view(r1p, r2p)


@pytest.mark.parametrize("by_vjl", [True, False], ids=["vj", "g"])
@pytest.mark.parametrize("kind", ["random", "planted"])
@pytest.mark.parametrize("lpad,nt,wide,indels", [
    (24, False, False, True),
    (40, False, True, True),
    (48, True, True, False),
    (96, True, False, True),
])
def test_plane_join_equals_dense_join_plain(lpad, nt, wide, indels, kind,
                                            by_vjl):
    random = kind == "random"
    d1 = _dense_db(150, lpad, nt, seed=7, short=random, wide=wide)
    d2 = _dense_db(180, lpad, nt, seed=8, src=None if random else d1,
                   short=random, wide=wide)
    a, _, ka = _rows(d1, lpad, 32, indels, wide, by_vjl, planes=True)
    b, _, kb = _rows(d2, lpad, 32, indels, wide, by_vjl, planes=True)
    work = K.upload_worklist(
        teng.worklist_from_keys(ka, d1.n, kb, d2.n, int(indels), 32, 32),
        "cpu")
    key, cnt = ("key64", "cnt64") if wide else ("key32", "cnt")
    modes = [(K.SC_PRODUCT, torch.int64), (K.SC_SUM, torch.int64)]
    if wide:
        modes.append((K.SC_RATIO, torch.float64))
    matched = 0
    for d in ((1,) if indels else (1, 2, 3)):
        for mode, dtype in modes:
            kw = dict(key=key, cnt=cnt, indels=indels, differences=d,
                      score_mode=mode, out_dtype=dtype, tile_m=32,
                      tile_n=32, r1p=8, r2p=128)
            got = _plane_join(a, b, work, **kw)
            want = K._dense_join_plain(a, b, work, **kw)
            if dtype == torch.float64:
                torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
            else:
                assert torch.equal(got, want), (d, mode)
            matched += int((want != 0).sum())
    assert matched > 0
