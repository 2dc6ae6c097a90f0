"""Plain reference for CompAIRR's overlap command (-m, one file or two)
at -d 2, product score, worked out from the AIRR TSVs alone with NumPy.
It imports nothing of the program under test.

Two rows match when their V genes and their J genes are equal, their
lengths are equal and at most two of their residues differ. Every
ordered pair (a row of set 1, a row of set 2) that matches adds
count_1 * count_2 to the cell of (repertoire 1, repertoire 2); a
self-comparison (one file) pairs the set with itself, each row with
itself included.

The pairs are found by the pigeonhole principle, a length at a time: two
substitutions touch at most two of the three pieces [0, L // 3),
[L // 3, 2L // 3) and [2L // 3, L) of a row of length L, so a matching
pair agrees on at least one of them. Rows that agree on a piece, with
their genes, are joined by a hash of the piece (overlap_d1's join), every
candidate is checked in full, and the pair ids are de-duplicated, so a
hash collision or a pair found through two pieces costs time and never
a wrong or a double pair.
"""

from __future__ import annotations

import numpy as np

from . import airr
from .overlap_d1 import _interned, _join, _piece_key


def match_pairs(A: dict, B: dict, diffs: int = 2):
    """All ordered pairs (index in A, index in B) of equal length and
    genes at most diffs (2, or 1 for a control) residues apart, sorted,
    as two int64 arrays. A and B hold seqs, lengths and vj."""
    found = []
    nb = len(B["lengths"])
    by_len_b = {L: np.flatnonzero(B["lengths"] == L)
                for L in np.unique(B["lengths"])}
    for L in np.unique(A["lengths"]):
        L = int(L)
        rb = by_len_b.get(L)
        if rb is None:
            continue
        ra = np.flatnonzero(A["lengths"] == L)
        sa, sb = A["seqs"][ra, :L], B["seqs"][rb, :L]
        va, vb = A["vj"][ra], B["vj"][rb]
        cuts = (0, L // 3, 2 * L // 3, L)
        for lo, hi in zip(cuts, cuts[1:]):
            ka = _piece_key(sa, va, lo, hi)
            kb = _piece_key(sb, vb, lo, hi)
            for ia, ib in _join(ka, kb):
                ok = ((va[ia] == vb[ib])
                      & ((sa[ia] != sb[ib]).sum(axis=1) <= diffs))
                found.append(ra[ia[ok]] * nb + rb[ib[ok]])
    ids = np.unique(np.concatenate(found)) if found else np.zeros(0, np.int64)
    return ids // nb, ids % nb


def solve(paths: list, diffs: int = 2, dtype=np.float64) -> dict:
    """The expected result of `-m -d 2` over the TSVs at paths (one file
    or two), product score. dtype is the type the scores are multiplied
    and summed in: float64 as the tool states; float32, or diffs 1, is a
    control. Returns what overlap_d1.solve returns: row and column
    labels, values [rows, cols] (float64), and the matched pairs' count
    and residues, and the inputs' rows and residues."""
    sets = [airr.read(p) for p in paths]
    v = _interned(sets, "v")
    j = _interned(sets, "j")
    nj = max(int(x.max()) + 1 for x in j)
    for s, vv, jj in zip(sets, v, j):
        s["vj"] = vv * nj + jj
    A = sets[0]
    B = sets[1] if len(sets) > 1 else sets[0]
    ia, ib = match_pairs(A, B, diffs)

    rows, row_of = np.unique(A["rep"], return_inverse=True)
    cols, col_of = np.unique(B["rep"], return_inverse=True)
    score = A["counts"][ia].astype(dtype) * B["counts"][ib].astype(dtype)
    acc = np.zeros((len(rows), len(cols)), dtype=dtype)
    np.add.at(acc, (row_of[ia], col_of[ib]), score)
    return {
        "rows": [x.decode() for x in rows],
        "cols": [x.decode() for x in cols],
        "values": acc.astype(np.float64),
        "pairs": int(len(ia)),
        "pair_residues": int(A["lengths"][ia].sum()),
        "input_rows": [int(len(s["lengths"])) for s in sets],
        "input_residues": [int(s["lengths"].sum()) for s in sets],
    }


CONTROLS = {"float32": {"dtype": np.float32}, "d1": {"diffs": 1}}


def solve_cli(flags: list, paths: list, control: str = None) -> dict:
    """solve() for the command-line flags of a traffic mix (-m -d 2);
    raises on any other flags (-i, -g, -x, a score, a thread count).
    control names one of CONTROLS, the reference computed below what the
    tool states."""
    if list(flags) != ["-m", "-d", "2"]:
        raise ValueError(f"the -d 2 reference does not implement {flags}")
    return solve(paths, **(CONTROLS[control] if control else {}))
