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
    return (K.device_args_raw(d1, oa, na, lpad, ka, dev),
            K.device_args_raw(d2, ob, nb, lpad, kb, dev),
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


def test_dense_match_rejects_cpu_worklist(cuda, sets):
    from compairr_tpu_torch.ops import kernels as K

    a, b, work = _inputs(sets, cuda, 128)
    with pytest.raises(ValueError):
        K.dense_match(a, b, work.cpu(), differences=1,
                      score_mode=K.SC_PRODUCT, tile_m=128, tile_n=128,
                      r1p=8, r2p=128)
