"""Shared inputs for the parity tests of the PyTorch port: the same
synthetic TSVs read by the JAX package and carried into the port's
SeqDB (compairr_tpu_torch.core.db.seqdb_from_arrays)."""

from compairr_tpu.config import Options
from compairr_tpu.core.db import GeneTables
from compairr_tpu.io.airr import read_db
from compairr_tpu.utils.progress import NullLogger
from compairr_tpu_torch.core.db import GeneTables as TGeneTables
from compairr_tpu_torch.core.db import seqdb_from_arrays

from synth import make_tsv

# the dbs fixture's shape in test_dense.py (400 x 500 rows, counts
# <= 3), with a 3-letter alphabet, 2 V / 2 J genes and lengths 6..9 so
# every distance 0..2 has hundreds of matching pairs
SET_A = dict(n_seqs=400, n_reps=5, seed=21)
SET_B = dict(n_seqs=500, n_reps=7, seed=22)
SHAPE = dict(alphabet_sub=3, n_v=2, n_j=2, len_range=(6, 9), max_count=3)


def write_pair(dirpath, **shape):
    """Paths of the two synthetic TSVs under dirpath."""
    kw = dict(SHAPE, **shape)
    a = make_tsv(str(dirpath / "a.tsv"), **SET_A, **kw)
    b = make_tsv(str(dirpath / "b.tsv"), **SET_B, **kw)
    return a, b


def read_pair(a_path, b_path, nucleotides=False):
    """((jax d1, jax d2), (port d1, port d2)) for the two files: the
    JAX package parses them, the port receives the same arrays."""
    genes = GeneTables()
    log = NullLogger()
    opt = Options(nucleotides=nucleotides)
    d1 = read_db(a_path, opt, genes, log, False, "1")
    d2 = read_db(b_path, opt, genes, log, False, "2")
    tgenes = TGeneTables()
    for name in genes.v_names:
        tgenes.intern_v(name)
    for name in genes.j_names:
        tgenes.intern_j(name)
    t1 = seqdb_from_arrays(d1, genes=tgenes)
    t2 = seqdb_from_arrays(d2, genes=tgenes)
    return (d1, d2), (t1, t2)
