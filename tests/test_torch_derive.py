"""The port's device derive (compairr_tpu_torch.ops.kernels.device_args_raw)
against the JAX package's (compairr_tpu.ops.pallas_kernels.device_args_raw):
the key-sorted residue rows and the key32 / rep / cnt rows must be
equal element for element, pads included. The JAX one-hot rows have
no counterpart in the port (its kernel reads residues) and are not
compared."""

import numpy as np
import pytest
import torch

from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("derive")))


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


def test_residue_packing_matches_jax(dbs):
    """6 five-bit residues per int32 word: the host pack is the JAX
    package's bit for bit, and the torch unpack inverts it."""
    jdb = dbs[0][1]
    lpad = jeng._round_up(int(jdb.longest), 8)
    m = K._canon_src(jdb.n + 1)
    packed = K._packed_upload(jdb, m, lpad, jdb.pad_value)
    np.testing.assert_array_equal(
        packed, P._packed_upload(jdb, m, lpad, jdb.pad_value)
    )
    rows = K._unpack_residues(torch.from_numpy(packed), lpad).numpy()
    np.testing.assert_array_equal(
        rows[: jdb.n, : jdb.seqs.shape[1]], jdb.seqs
    )
    assert (rows[jdb.n :] == jdb.pad_value).all()
