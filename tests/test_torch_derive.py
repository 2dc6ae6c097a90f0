"""The port's device derive (compairr_tpu_torch.ops.kernels.device_args_raw)
against the JAX package's (compairr_tpu.ops.pallas_kernels.device_args_raw):
the key-sorted residue rows and the key32 / rep / cnt rows must be
equal element for element, pads included. The JAX one-hot rows have
no counterpart in the port (its kernel reads residues) and are not
compared. The derive's rows from the raw int8 rows (derive_rows_plain,
the CPU side of csrc/derive_rows.cu) are also held, with their planes,
to the rows JAX derives from its packed upload."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from test_torch_tile_planes import _planes_ref
from torch_port_data import read_pair, write_pair


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("derive")))


@pytest.fixture(scope="module")
def nt_dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("derive_nt"),
                                 nt=True, alphabet_sub=4), nucleotides=True)


def _jax_rows(db, tile, by_vjl, lpad):
    order, key, npad = jeng.pack_keys(db, tile, by_vjl)
    dev = P.device_args_raw(
        db, order, npad, lpad, indels=False, sort_key=key
    )["a"]
    return order, key, npad, {
        "seqs": np.asarray(dev["seqs"]),
        "key32": np.asarray(dev["key32"]).ravel(),
        "rep": np.asarray(dev["rep"]).ravel(),
        "cnt": np.asarray(dev["cnt"]).ravel(),
        "scal4": np.asarray(dev["scal4"]),
    }


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("tile,by_vjl", [(128, True), (64, False)])
def test_device_args_raw_matches_jax(dbs, side, tile, by_vjl):
    jdb, tdb = dbs[0][side], dbs[1][side]
    lpad = jeng._round_up(int(jdb.longest), 8)
    order, key, npad, want = _jax_rows(jdb, tile, by_vjl, lpad)
    t_order, t_key, t_npad = teng.pack_keys(tdb, tile, by_vjl)
    assert t_npad == npad
    np.testing.assert_array_equal(t_order, order)
    np.testing.assert_array_equal(t_key, key)

    got = K.device_args_raw(tdb, t_order, t_npad, lpad, t_key, "cpu")
    for k in ("seqs", "key32", "rep", "cnt"):
        assert got[k].device.type == "cpu"
    assert got["seqs"].dtype == torch.int8
    assert got["seqs"].shape == (npad, lpad)
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])
    np.testing.assert_array_equal(got["key32"].numpy(), want["key32"])
    np.testing.assert_array_equal(got["rep"].numpy(), want["rep"])
    # JAX carries counts as f32 in the "cnt" row and as int32 in the
    # v3 kernel's scal4 rows (key, rep, count, 0)
    np.testing.assert_array_equal(
        got["cnt"].numpy(), want["cnt"].astype(np.int64)
    )
    np.testing.assert_array_equal(got["key32"].numpy(), want["scal4"][0])
    np.testing.assert_array_equal(got["rep"].numpy(), want["scal4"][1])
    np.testing.assert_array_equal(got["cnt"].numpy(), want["scal4"][2])


def test_chunked_derive_matches_jax(dbs, monkeypatch):
    """The row-chunked gather (bounding int32 temporaries at scale)
    gives the same rows as the JAX single-shot derive."""
    jdb, tdb = dbs[0][0], dbs[1][0]
    lpad = jeng._round_up(int(jdb.longest), 8)
    _, _, _, want = _jax_rows(jdb, 128, True, lpad)
    monkeypatch.setattr(K, "_DERIVE_CHUNK", 64)
    order, key, npad = teng.pack_keys(tdb, 128, True)
    got = K.device_args_raw(tdb, order, npad, lpad, key, "cpu")
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])


def _empty(db):
    """db cut to no rows."""
    return replace(db, **{f: getattr(db, f)[:0] for f in (
        "seqs", "lengths", "counts", "rep_no", "v_no", "j_no")},
        sequence_ids=[], keep=[])


@pytest.mark.parametrize("case", ["w_lt_lpad", "w_eq_lpad", "nucleotides",
                                  "empty"])
def test_raw_rows_derive_matches_jax(dbs, nt_dbs, case):
    """The derive from the SeqDB's int8 rows as they are
    (derive_rows_plain, through both derives) against the JAX package's
    from its 5-bit packed upload: seqs and rseqs equal to the rows of
    its device_args_raw and device_rows_raw, pads included, and planes
    and rplanes equal to the bit-by-bit planes of those rows."""
    (jdb, _), (tdb, _) = nt_dbs if case == "nucleotides" else dbs
    if case == "empty":
        jdb, tdb = _empty(jdb), _empty(tdb)
    w = tdb.seqs.shape[1]
    lpad = w if case == "w_eq_lpad" else jeng._round_up(w, 8)
    assert (lpad == w) == (case == "w_eq_lpad")
    order, key, npad = jeng.pack_keys(jdb, 128, True)
    jargs = P.device_args_raw(jdb, order, npad, lpad, indels=True,
                              sort_key=key)["a"]
    jrows, _ = P.device_rows_raw(jdb, order, npad, lpad, True,
                                 sort_key=key, pad_salt=0)
    t_order, t_key, t_npad = teng.pack_keys(tdb, 128, True)
    assert t_npad == npad
    targs = K.device_args_raw(tdb, t_order, npad, lpad, t_key, "cpu",
                              indels=True, planes=True)
    trows = K.device_rows_raw(tdb, t_order, npad, lpad, True, t_key, 0,
                              "cpu", wide=False, planes=True)
    n_planes = int(tdb.pad_value).bit_length()
    for got, want in ((targs, jargs), (trows, jrows)):
        for rows, planes in (("seqs", "planes"), ("rseqs", "rplanes")):
            ref = np.asarray(want[rows])
            np.testing.assert_array_equal(got[rows].numpy(), ref)
            np.testing.assert_array_equal(got[planes].numpy(),
                                          _planes_ref(ref, n_planes))
    assert (targs["seqs"].numpy()[tdb.n :] == tdb.pad_value).all()
