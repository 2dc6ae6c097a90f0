"""The residue bit planes that csrc/dense_match.cu reads
(compairr_tpu_torch.ops.kernels.residue_planes and device_args_raw's
planes), on the CPU:

  * the derive against a numpy bit-by-bit reference, at every chunk
    count the kernel distinguishes (lpad 8 to 136, C = 1 to 5), for
    amino acids (5 planes) and nucleotides (3), with pad rows and
    bit 31 set;
  * the kernel's distance: popcount of OR_q (A_q ^ B_q), summed over the
    chunks, equals the byte Hamming distance that dense_match_plain
    counts, for real and pad rows;
  * the derive's place on the path: dense_matrix builds planes for
    dense_match's runs only, and still equals JAX's v3 kernel
    (interpret mode);
  * the wrapper's checks of the planes.

Every quantity is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

from compairr_tpu.constants import SCORE_MEAN, SCORE_PRODUCT
from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair

LPADS = [8, 24, 32, 40, 96, 136]  # C = 1, 1, 1, 2, 3, 5
ALPHABETS = [("aa", 20), ("nt", 4)]  # name, pad code (the largest code)


def _rows(n, lpad, pad, seed):
    """int8 [n, lpad] residue rows: real rows of random lengths (pad
    residues after them), every 7th row all pad, and row 1 all the
    largest real code (bit 31 of plane 0 set where lpad >= 32)."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, pad, size=(n, lpad)).astype(np.int8)
    lengths = rng.integers(1, lpad + 1, size=n)
    seqs[np.arange(lpad)[None, :] >= lengths[:, None]] = pad
    seqs[::7] = pad
    seqs[1] = pad - 1
    return seqs


def _planes_ref(seqs, n_planes):
    """numpy, bit by bit: word [row, c, q] bit p = bit q of residue
    32 c + p, 0 past lpad; as int32 (bit 31 is the sign bit)."""
    n, lpad = seqs.shape
    c = -(-lpad // 32)
    out = np.zeros((n, c, n_planes), dtype=np.uint32)
    for pos in range(lpad):
        for q in range(n_planes):
            bit = ((seqs[:, pos].astype(np.uint32) >> q) & 1) << (pos % 32)
            out[:, pos // 32, q] |= bit.astype(np.uint32)
    return out.view(np.int32)


@pytest.mark.parametrize("alpha,pad", ALPHABETS, ids=[a for a, _ in ALPHABETS])
@pytest.mark.parametrize("lpad", LPADS)
def test_residue_planes_match_bitwise_reference(lpad, alpha, pad):
    seqs = _rows(50, lpad, pad, seed=lpad)
    n_planes = pad.bit_length()
    got = K.residue_planes(torch.from_numpy(seqs), n_planes)
    assert got.dtype == torch.int32
    assert got.shape == (50, K.plane_chunks(lpad), n_planes)
    assert got.is_contiguous()
    want = _planes_ref(seqs, n_planes)
    np.testing.assert_array_equal(got.numpy(), want)
    if lpad >= 32:
        # row 1 is all pad - 1 (19 or 3): bit 31 of plane 0 is set
        assert got[1, 0, 0] < 0


def test_residue_planes_chunked_derive(monkeypatch):
    """Row-chunked (bounding the int64 temporaries) gives the same words."""
    seqs = torch.from_numpy(_rows(300, 40, 20, seed=3))
    whole = K.residue_planes(seqs, 5)
    monkeypatch.setattr(K, "_PLANE_DERIVE_ELEMS", 1000)
    np.testing.assert_array_equal(K.residue_planes(seqs, 5).numpy(),
                                  whole.numpy())


def _plane_hamming(pa, pb):
    """The kernel's distance on plane words: popc(OR_q (A_q ^ B_q))
    summed over the chunks, for row pairs [n, C, P] x [n, C, P]."""
    x = (pa.numpy().view(np.uint32) ^ pb.numpy().view(np.uint32))
    mask = np.bitwise_or.reduce(x, axis=2)
    bits = np.unpackbits(mask.view(np.uint8), axis=-1)
    return bits.reshape(len(mask), -1).sum(1)


@pytest.mark.parametrize("alpha,pad", ALPHABETS, ids=[a for a, _ in ALPHABETS])
@pytest.mark.parametrize("lpad", LPADS)
def test_plane_distance_equals_byte_hamming(lpad, alpha, pad):
    """Random pairs of real and pad rows, and each row with itself."""
    seqs = torch.from_numpy(_rows(200, lpad, pad, seed=100 + lpad))
    planes = K.residue_planes(seqs, pad.bit_length())
    rng = np.random.default_rng(lpad)
    i = torch.from_numpy(rng.integers(0, 200, 2000))
    j = torch.from_numpy(rng.integers(0, 200, 2000))
    got = _plane_hamming(planes[i], planes[j])
    want = (seqs[i] != seqs[j]).sum(1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any() and (want == 0).any()
    assert (_plane_hamming(planes, planes) == 0).all()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("planes")))


def test_device_args_raw_planes_only_when_asked(dbs):
    (_, _), (t1, _) = dbs
    lpad = teng._round_up(int(t1.longest), 8)
    order, key, npad = teng.pack_keys(t1, 128, True)
    plain = K.device_args_raw(t1, order, npad, lpad, key, "cpu")
    assert "planes" not in plain
    rows = K.device_args_raw(t1, order, npad, lpad, key, "cpu", planes=True)
    assert rows["planes"].shape == (npad, 1, 5)
    assert torch.equal(rows["planes"], K.residue_planes(rows["seqs"], 5))
    # pad rows (all pad residue 20 = 0b10100) set planes 2 and 4 on
    # every position below lpad and nothing else
    full = (1 << lpad) - 1
    pads = rows["planes"][t1.n :].numpy().view(np.uint32)
    assert (pads[:, 0] == [0, 0, full, 0, full]).all()


@pytest.mark.parametrize("genes,d,score,f", [
    (False, 2, SCORE_PRODUCT, False),
    (True, 1, SCORE_MEAN, False),
    (True, 2, SCORE_PRODUCT, True),
])
def test_dense_matrix_builds_planes_and_matches_jax_v3(dbs, monkeypatch,
                                                       genes, d, score, f):
    """dense_matrix asks for planes on dense_match's runs (and on no
    other kernel's) and equals JAX's v3 kernel in interpret mode."""
    (d1, d2), (t1, t2) = dbs
    asked = []
    real = K.device_args_raw

    def spy(*a, **k):
        asked.append(k.get("planes", False))
        return real(*a, **k)

    monkeypatch.setattr(K, "device_args_raw", spy)
    jspec = jeng.MatchSpec(differences=d, indels=False, ignore_genes=genes)
    tspec = teng.MatchSpec(differences=d, indels=False, ignore_genes=genes)
    want = jeng.dense_matrix(d1, d2, jspec, score, f, engine="pallas")
    assert P.LAST_DENSE_KERNEL == "v3"
    got = teng.dense_matrix(t1, t2, tspec, score, f, device="cpu")
    assert asked == [True, True]
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    asked.clear()
    ispec = teng.MatchSpec(differences=1, indels=True, ignore_genes=genes)
    teng.dense_matrix(t1, t2, ispec, SCORE_PRODUCT, False, device="cpu")
    assert asked == [False, False]


@pytest.fixture(scope="module")
def rows(dbs):
    (_, _), (t1, t2) = dbs
    lpad = teng._round_up(int(max(t1.longest, t2.longest)), 8)
    out = []
    for db in (t1, t2):
        order, key, npad = teng.pack_keys(db, 128, True)
        out.append(K.device_args_raw(db, order, npad, lpad, key, "cpu",
                                     planes=True))
    work = teng.worklist_from_keys(
        teng.pack_keys(t1, 128, True)[1], t1.n,
        teng.pack_keys(t2, 128, True)[1], t2.n, 0, 128, 128)
    return out[0], out[1], K.upload_worklist(work, "cpu")


def test_wrapper_with_planes_equals_without(rows):
    """The CPU path is the plain version: planes are checked, not read."""
    a, b, work = rows
    kw = dict(differences=2, score_mode=K.SC_PRODUCT, tile_m=128,
              tile_n=128, r1p=8, r2p=128)
    with_planes = K.dense_match(a, b, work, **kw)
    bare = [{k: v for k, v in s.items() if k != "planes"} for s in (a, b)]
    assert torch.equal(with_planes, K.dense_match(*bare, work, **kw))
    assert int(with_planes.sum()) > 0


@pytest.mark.parametrize("bad", [
    "dtype", "chunks", "six_planes", "zero_planes", "rows", "strided",
    "plane_count_differs", "one_side",
])
def test_wrapper_rejects_bad_planes(rows, bad):
    a, b, work = rows
    a, b = dict(a), dict(b)
    pl = a["planes"]
    if bad == "dtype":
        a["planes"] = pl.to(torch.int64)
    elif bad == "chunks":
        a["planes"] = torch.cat([pl, pl], dim=1)
    elif bad == "six_planes":
        a["planes"] = torch.cat([pl, pl[:, :, :1]], dim=2)
        b["planes"] = torch.cat([b["planes"], b["planes"][:, :, :1]], dim=2)
    elif bad == "zero_planes":
        a["planes"] = pl[:, :, :0].contiguous()
    elif bad == "rows":
        a["planes"] = pl[:-1].contiguous()
    elif bad == "strided":
        a["planes"] = torch.cat([pl, pl], dim=2)[:, :, ::2]
    elif bad == "plane_count_differs":
        a["planes"] = pl[:, :, :3].contiguous()
    elif bad == "one_side":
        del b["planes"]
    with pytest.raises(ValueError):
        K.dense_match(a, b, work, differences=1, score_mode=K.SC_PRODUCT,
                      tile_m=128, tile_n=128, r1p=8, r2p=128)
