"""The port's multi-device dry run (compairr_tpu_torch/graft_entry.py,
the counterpart of __graft_entry__.dryrun_multichip) on the CPU over 8
shards: sharded and ring matrices, CLI bytes on 1 and 8 devices and a
two-process run, each exactly equal to one device's."""


def test_dryrun_multichip_8(capsys):
    from compairr_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    assert "matrix sum 238" in capsys.readouterr().out


def test_entry_on_cpu_equals_jax_and_dense_span():
    """entry(device="cpu")'s step gives, cell for cell, what jax.jit of
    the JAX package's entry() step gives on the same sets, and the raw
    sums of engine.dense_span on the same plan."""
    import sys

    import jax
    import numpy as np
    import torch

    import __graft_entry__ as ge
    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.graft_entry import _synthetic_db, entry
    from compairr_tpu_torch.ops import engine as E

    step, args = entry(device="cpu")
    out = step(*args)
    assert out.dtype == torch.int64
    assert out.shape[0] >= 4 and out.shape[1] >= 4
    assert np.isfinite(out.numpy()).all()

    fn, jargs = ge.entry()
    want = np.asarray(jax.jit(fn)(*jargs))
    assert want.shape == tuple(out.shape)
    np.testing.assert_array_equal(out.numpy(), want)

    d1, d2 = _synthetic_db(512, 4, seed=1), _synthetic_db(512, 4, seed=2)
    plan = E.dense_plan(d1, d2, E.MatchSpec(2, False, False), SCORE_PRODUCT,
                        False)
    assert plan.kind == "dense_match"
    cpu = torch.device("cpu")
    span = E.dense_span(
        plan, E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a,
                           cpu),
        E.dense_side(plan, d2, plan.order_b, plan.key_b, plan.npad_b, cpu))
    assert torch.equal(out, span)
    assert "jax" in sys.modules  # the JAX side really ran


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import pytest
    import torch

    from compairr_tpu_torch.graft_entry import entry

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        entry()
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    step, args = entry()
    assert args[0]["rep"].device.type == "cpu"


def test_planted_entry_on_cpu_equals_jax_dense_matrix():
    """entry(device="cpu", planted=True): the same step over entry()'s
    sets with 32 rows of set 1 planted into set 2 gives nonzero sums,
    equal to engine.dense_span's raw sums and, cell for cell over the
    real repertoires, to the JAX package's dense_matrix on the same
    planted sets."""
    import numpy as np
    import torch

    import __graft_entry__ as ge
    from compairr_tpu.constants import SCORE_PRODUCT as J_PRODUCT
    from compairr_tpu.ops.engine import MatchSpec, dense_matrix
    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.graft_entry import _entry_dbs, _plant, entry
    from compairr_tpu_torch.ops import engine as E

    step, args = entry(device="cpu", planted=True)
    out = step(*args)
    assert int(out.sum()) > 0

    d1, d2 = _entry_dbs(planted=True)
    plan = E.dense_plan(d1, d2, E.MatchSpec(2, False, False), SCORE_PRODUCT,
                        False)
    cpu = torch.device("cpu")
    span = E.dense_span(
        plan, E.dense_side(plan, d1, plan.order_a, plan.key_a, plan.npad_a,
                           cpu),
        E.dense_side(plan, d2, plan.order_b, plan.key_b, plan.npad_b, cpu))
    assert torch.equal(out, span)

    j1, j2 = ge._synthetic_db(512, 4, seed=1), ge._synthetic_db(512, 4, seed=2)
    _plant(j1, j2, 32, seed=3)  # numpy only: the same rows in JAX's SeqDB
    np.testing.assert_array_equal(j2.seqs, d2.seqs)
    want = dense_matrix(j1, j2, MatchSpec(2, False, False), J_PRODUCT, False)
    assert want.sum() > 0
    np.testing.assert_array_equal(out.numpy()[: want.shape[0],
                                              : want.shape[1]], want)
    assert not out.numpy()[want.shape[0]:].any()
    assert not out.numpy()[:, want.shape[1]:].any()
