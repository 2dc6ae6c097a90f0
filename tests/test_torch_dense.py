"""The port's dense engine, compairr_tpu_torch.ops.engine.dense_matrix on
the CPU (the dense_match kernel's plain version), against the JAX
package's dense_matrix through its Pallas v3 kernel (interpret mode)
and through its XLA scan path. Matrices are integer (or, for mean,
half-integer) sums, so equality is exact. Configurations whose JAX
kernels are not ported yet must raise NotImplementedError."""

import numpy as np
import pytest

from compairr_tpu.constants import (
    SCORE_JACCARD,
    SCORE_MAX,
    SCORE_MEAN,
    SCORE_MIN,
    SCORE_PRODUCT,
    SCORE_RATIO,
)
from compairr_tpu.ops import engine as jeng
from compairr_tpu_torch.ops import engine as teng
from compairr_tpu_torch.ops import kernels as K

from torch_port_data import read_pair, write_pair


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("dense")))


def _specs(d, genes):
    return (
        jeng.MatchSpec(differences=d, indels=False, ignore_genes=genes),
        teng.MatchSpec(differences=d, indels=False, ignore_genes=genes),
    )


CASES = [
    (0, False, SCORE_PRODUCT, False),
    (1, False, SCORE_PRODUCT, False),
    (2, False, SCORE_PRODUCT, False),
    (1, True, SCORE_MIN, False),
    (2, True, SCORE_PRODUCT, False),
    (1, False, SCORE_MAX, True),
    (2, False, SCORE_MEAN, False),
    (2, False, SCORE_JACCARD, False),
    (0, True, SCORE_MAX, False),
]


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("d,genes,score,f", CASES)
def test_dense_matrix_matches_jax(dbs, engine, d, genes, score, f):
    (d1, d2), (t1, t2) = dbs
    jspec, tspec = _specs(d, genes)
    want = jeng.dense_matrix(d1, d2, jspec, score, f, engine=engine)
    got = teng.dense_matrix(t1, t2, tspec, score, f, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_dense_nucleotides_match_jax(tmp_path):
    """Nucleotide sets (pad residue 4, rows wider than 32), compared
    with themselves so that matches exist."""
    (d1, _), (t1, _) = read_pair(
        *write_pair(tmp_path, nt=True, alphabet_sub=2, len_range=(33, 36)),
        nucleotides=True,
    )
    assert t1.pad_value == 4 and t1.longest > 32
    jspec, tspec = _specs(2, True)
    want = jeng.dense_matrix(
        d1, d1, jspec, SCORE_PRODUCT, False, engine="pallas"
    )
    got = teng.dense_matrix(t1, t1, tspec, SCORE_PRODUCT, False, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("tile", [64, 256])
def test_dense_self_comparison_and_tiles(dbs, tile):
    """Self-comparison (one derive shared by both sides) at other tile
    sizes equals the JAX XLA engine."""
    (d1, _), (t1, _) = dbs
    jspec, tspec = _specs(2, False)
    want = jeng.dense_matrix(
        d1, d1, jspec, SCORE_PRODUCT, False, engine="xla"
    )
    got = teng.dense_matrix(
        t1, t1, tspec, SCORE_PRODUCT, False, tile_m=tile, tile_n=tile,
        device="cpu",
    )
    np.testing.assert_array_equal(got, want)


def test_dense_device_from_env(dbs, monkeypatch):
    """COMPAIRR_DEVICE=cpu is the CLI's CPU request."""
    (_, _), (t1, t2) = dbs
    _, tspec = _specs(1, False)
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    a = teng.dense_matrix(t1, t2, tspec, SCORE_PRODUCT, False)
    b = teng.dense_matrix(t1, t2, tspec, SCORE_PRODUCT, False, device="cpu")
    np.testing.assert_array_equal(a, b)


def _big_counts(db, value):
    from dataclasses import replace

    counts = db.counts.copy()
    counts[0] = value
    return replace(db, counts=counts)


@pytest.mark.parametrize(
    "case,kernel",
    [
        ("indels", "_make_dense_v2c_kernel"),
        ("ratio", "_make_kernel"),
        ("min_big_counts", "_make_kernel"),
        ("counts_2_16", "_make_kernel"),
    ],
)
def test_unported_configs_raise(dbs, case, kernel):
    """Runs the JAX package sends to its v2c or v1 kernels raise,
    naming the kernel still to port; none falls back silently."""
    (_, _), (t1, t2) = dbs
    spec = teng.MatchSpec(
        differences=1, indels=case == "indels", ignore_genes=False
    )
    score = {"ratio": SCORE_RATIO, "min_big_counts": SCORE_MIN}.get(
        case, SCORE_PRODUCT
    )
    if case == "min_big_counts":
        t1 = _big_counts(t1, K._V2_GE_CMAX + 1)
    elif case == "counts_2_16":
        t1 = _big_counts(t1, 1 << 16)
    with pytest.raises(NotImplementedError, match=kernel):
        teng.dense_matrix(t1, t2, spec, score, False, device="cpu")


def test_dense_exclude_self_rejected(dbs):
    (_, _), (t1, _) = dbs
    spec = teng.MatchSpec(
        differences=1, indels=False, ignore_genes=False, exclude_self=True
    )
    with pytest.raises(ValueError):
        teng.dense_matrix(t1, t1, spec, SCORE_PRODUCT, False, device="cpu")
