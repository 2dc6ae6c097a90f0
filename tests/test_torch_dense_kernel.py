"""dense_match's plain PyTorch version (the CPU side of the wrapper in
compairr_tpu_torch/ops/kernels.py) against the JAX v3 dense kernel
(_dense_v3_fn, Pallas interpret mode) on the same derived rows and the
same worklist. Every quantity is an integer sum, so equality is exact;
JAX's mean halves each pair on the device, the port once at the end,
so the port's mean matrix is twice JAX's."""

import numpy as np
import pytest
import torch

from compairr_tpu.constants import (
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MIN,
    SCORE_PRODUCT,
)
from compairr_tpu.ops import engine as jeng
from compairr_tpu.ops import pallas_kernels as P
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair

TILE = 128


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Both packages' derived rows for the two sets, and the worklist."""
    (d1, d2), (t1, t2) = read_pair(
        *write_pair(tmp_path_factory.mktemp("kernel"))
    )
    lpad = jeng._round_up(int(max(d1.longest, d2.longest)), 8)
    oa, ka, na = jeng.pack_keys(d1, TILE, True)
    ob, kb, nb = jeng.pack_keys(d2, TILE, True)
    ja = P.device_args_raw(d1, oa, na, lpad, indels=False, sort_key=ka)
    jb = P.device_args_raw(d2, ob, nb, lpad, indels=False, sort_key=kb)
    ta = K.device_args_raw(t1, oa, na, lpad, ka, "cpu")
    tb = K.device_args_raw(t2, ob, nb, lpad, kb, "cpu")
    work = jeng.worklist_from_keys(ka, d1.n, kb, d2.n, 0, TILE, TILE)
    r1p = jeng._round_up(d1.repertoire_count, 8)
    r2p = jeng._round_up(d2.repertoire_count, 128)
    return ja, jb, ta, tb, work, r1p, r2p


MODES = [
    (SCORE_PRODUCT, False),
    (SCORE_MEAN, False),
    (SCORE_MIN, False),
    (SCORE_MAX, False),
    (SCORE_PRODUCT, True),  # -f: every matched pair scores 1
]


@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize(
    "score,f", MODES, ids=["product", "mean", "min", "max", "f"]
)
def test_plain_matches_jax_v3(rows, d, score, f, monkeypatch):
    ja, jb, ta, tb, work, r1p, r2p = rows
    calls = []
    real = P._dense_v3_fn

    def probe(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(P, "_dense_v3_fn", probe)
    want = np.asarray(
        P.dense_matrix_pallas(
            ja["a"], jb["b"], work,
            differences=d, indels=False, ignore_genes=False,
            score_int=score, ignore_counts=f, tile_m=TILE, tile_n=TILE,
            r1p=r1p, r2p=r2p, interpret=True,
        ),
        dtype=np.float64,
    )
    assert calls and P.LAST_DENSE_KERNEL == "v3"

    before = dict(K.LAUNCHES)
    got = K.dense_match(
        ta, tb, K.upload_worklist(teng.order_colmajor(work), "cpu"),
        differences=d, score_mode=K.score_mode(score, f),
        tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p,
    )
    # the plain version is no launch
    assert K.LAUNCHES == before
    assert got.dtype == torch.int64 and got.shape == (r1p, r2p)
    scale = 2.0 if (score == SCORE_MEAN and not f) else 1.0
    np.testing.assert_array_equal(got.numpy(), want * scale)
    assert want.sum() > 0


def test_plain_is_order_invariant(rows):
    """Row-major and column-major worklists give the same matrix."""
    _, _, ta, tb, work, r1p, r2p = rows
    kw = dict(differences=2, score_mode=K.SC_PRODUCT, tile_m=TILE,
              tile_n=TILE, r1p=r1p, r2p=r2p)
    m0 = K.dense_match(ta, tb, K.upload_worklist(work, "cpu"), **kw)
    m1 = K.dense_match(
        ta, tb, K.upload_worklist(teng.order_colmajor(work), "cpu"), **kw
    )
    assert torch.equal(m0, m1)


@pytest.mark.parametrize(
    "bad", ["seqs_dtype", "rep_dtype", "work_shape", "width", "r2p"]
)
def test_wrapper_rejects_bad_inputs(rows, bad):
    _, _, ta, tb, work, r1p, r2p = rows
    # shapes and types raise ValueError; repertoire indices beyond the
    # matrix fail the wrapper's device-side check (RuntimeError)
    error = ValueError
    if bad == "r2p":
        # set 2 has 7 repertoires: a 4-column matrix cannot hold them
        r2p, error = 4, RuntimeError
    ta, tb = dict(ta), dict(tb)
    w = K.upload_worklist(work, "cpu")
    if bad == "seqs_dtype":
        ta["seqs"] = ta["seqs"].to(torch.int32)
    elif bad == "rep_dtype":
        tb["rep"] = tb["rep"].to(torch.int64)
    elif bad == "work_shape":
        w = w.reshape(-1)
    elif bad == "width":
        tb["seqs"] = tb["seqs"][:, :-8].contiguous()
    with pytest.raises(error):
        K.dense_match(
            ta, tb, w, differences=1, score_mode=K.SC_PRODUCT,
            tile_m=TILE, tile_n=TILE, r1p=r1p, r2p=r2p,
        )
