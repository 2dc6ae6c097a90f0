"""Plain reference for CompAIRR's overlap (-m) and existence (-x)
commands at -d 1, with or without -i, product score, worked out from the
AIRR TSVs alone with NumPy. It imports nothing of the program under test.

Two rows match when their V genes and their J genes are equal and their
sequences are at most one substitution apart or, with indels, one
deletion from the longer gives the shorter. Every ordered pair (a row of
set 1, a row of set 2) that matches adds count_1 * count_2 to the cell
of (repertoire 1, repertoire 2) under -m, or (row 1, repertoire 2) under
-x; a self-comparison (-m with one file) pairs the set with itself,
each row with itself included.

The pairs are found by the pigeonhole principle, a length at a time: a
pair of rows of length L one substitution apart agrees on its first
L // 2 residues or on the rest; a row of length L and one of L + 1 that
loses residue p agree on their first L // 2 residues (p >= L // 2) or on
the short row's rest against the long row's last L - L // 2 (p < L // 2).
Rows that agree on such a piece, with their genes, are joined by a hash
of the piece, and every candidate is then checked in full, so a hash
collision costs time and never a wrong pair.
"""

from __future__ import annotations

import numpy as np

from . import airr

_MIX = np.uint64(0x9E3779B97F4A7C15)
_BLOCK = 1 << 21


def _piece_key(rows: np.ndarray, vj: np.ndarray, lo: int, hi: int):
    """uint64 key of residues [lo, hi) of each row and its genes."""
    code = np.zeros(len(rows), dtype=np.uint64)
    for p in range(lo, hi):
        code = (code << np.uint64(5)) ^ rows[:, p].astype(np.uint64)
    return code ^ (vj.astype(np.uint64) * _MIX)


def _join(ka: np.ndarray, kb: np.ndarray):
    """Every (i, j) with ka[i] == kb[j], yielded in blocks of ka."""
    order = np.argsort(kb)
    sk = kb[order]
    order_a = np.argsort(ka)
    for b in range(0, len(ka), _BLOCK):
        rows = order_a[b:b + _BLOCK]
        k = ka[rows]
        lo = np.searchsorted(sk, k, "left")
        cnt = np.searchsorted(sk, k, "right") - lo
        total = int(cnt.sum())
        if not total:
            continue
        ia = np.repeat(rows, cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ib = order[np.repeat(lo, cnt) + np.arange(total) - first]
        yield ia, ib


def _hamming_ok(a, b, L):
    return (a[:, :L] != b[:, :L]).sum(axis=1) <= 1


def _one_deletion(short, long_, L):
    """long_ (length L + 1) with one residue deleted equals short
    (length L): its common prefix and common suffix cover L."""
    pre = np.cumprod(short[:, :L] == long_[:, :L], axis=1).sum(axis=1)
    suf = np.cumprod((short[:, :L] == long_[:, 1:L + 1])[:, ::-1],
                     axis=1).sum(axis=1)
    return pre + suf >= L


def match_pairs(A: dict, B: dict, indels: bool):
    """All matching ordered pairs (index in A, index in B), sorted, as
    two int64 arrays. A and B hold seqs, lengths and vj (one gene key a
    row)."""
    found = []
    nb = len(B["lengths"])
    by_len_a = {L: np.flatnonzero(A["lengths"] == L)
                for L in np.unique(A["lengths"])}
    by_len_b = {L: np.flatnonzero(B["lengths"] == L)
                for L in np.unique(B["lengths"])}

    def run(ra, rb, pieces, check):
        """Join rows ra of A with rows rb of B on each (lo_a, hi_a,
        lo_b, hi_b) piece; keep the pairs that pass check."""
        if not len(ra) or not len(rb):
            return
        sa, sb = A["seqs"][ra], B["seqs"][rb]
        va, vb = A["vj"][ra], B["vj"][rb]
        for lo_a, hi_a, lo_b, hi_b in pieces:
            ka = _piece_key(sa, va, lo_a, hi_a)
            kb = _piece_key(sb, vb, lo_b, hi_b)
            for ia, ib in _join(ka, kb):
                ok = (va[ia] == vb[ib]) & check(sa[ia], sb[ib])
                found.append(ra[ia[ok]] * nb + rb[ib[ok]])

    for L, ra in by_len_a.items():
        L = int(L)
        h = L // 2
        rb = by_len_b.get(L, np.zeros(0, dtype=np.int64))
        run(ra, rb, [(0, h, 0, h), (h, L, h, L)],
            lambda a, b: _hamming_ok(a, b, L))
        if not indels:
            continue
        # A short (L), B long (L + 1)
        rb = by_len_b.get(L + 1, np.zeros(0, dtype=np.int64))
        run(ra, rb, [(0, h, 0, h), (h, L, h + 1, L + 1)],
            lambda a, b: _one_deletion(a, b, L))
        # A long (L), B short (L - 1)
        s = L - 1
        hs = s // 2
        rb = by_len_b.get(s, np.zeros(0, dtype=np.int64))
        if s >= 1:
            run(ra, rb, [(0, hs, 0, hs), (hs + 1, L, hs, s)],
                lambda a, b: _one_deletion(b, a, s))
    ids = np.unique(np.concatenate(found)) if found else np.zeros(0, np.int64)
    return ids // nb, ids % nb


def _interned(sets: list, field: str) -> list:
    """Each set's strings of `field` as numbers shared by all sets."""
    allv = np.concatenate([s[field] for s in sets])
    _, inv = np.unique(allv, return_inverse=True)
    out, at = [], 0
    for s in sets:
        out.append(inv[at:at + len(s[field])].astype(np.int64))
        at += len(s[field])
    return out


def solve(paths: list, mode: str, indels: bool = True,
          dtype=np.float64) -> dict:
    """The expected result of `-m` (mode "m", one or two files) or `-x`
    (mode "x", queries then set) at -d 1 over the TSVs at paths, product
    score. dtype is the type the scores are multiplied and summed in:
    float64 as the tool states; a lower one, or indels=False, is a
    control. Returns row labels, column labels, values [rows, cols]
    (float64), and the matched pairs' count and residues (the shorter
    row's length summed over the pairs)."""
    sets = [airr.read(p) for p in paths]
    v = _interned(sets, "v")
    j = _interned(sets, "j")
    nj = max(int(x.max()) + 1 for x in j)
    for s, vv, jj in zip(sets, v, j):
        s["vj"] = vv * nj + jj
    A = sets[0]
    B = sets[1] if len(sets) > 1 else sets[0]
    ia, ib = match_pairs(A, B, indels)

    cols, col_of = np.unique(B["rep"], return_inverse=True)
    if mode == "m":
        rows, row_of = np.unique(A["rep"], return_inverse=True)
        r = row_of[ia]
    elif mode == "x":
        if len(np.unique(A["rep"])) > 1:
            raise ValueError("-x takes one repertoire in its first file")
        rows = A["seq_ids"]
        r = ia
    else:
        raise ValueError(f"mode {mode!r}")
    score = A["counts"][ia].astype(dtype) * B["counts"][ib].astype(dtype)
    acc = np.zeros((len(rows), len(cols)), dtype=dtype)
    np.add.at(acc, (r, col_of[ib]), score)
    residues = np.minimum(A["lengths"][ia], B["lengths"][ib])
    return {
        "rows": [x.decode() for x in rows],
        "cols": [x.decode() for x in cols],
        "values": acc.astype(np.float64),
        "pairs": int(len(ia)),
        "pair_residues": int(residues.sum()),
        "input_rows": [int(len(s["lengths"])) for s in sets],
        "input_residues": [int(s["lengths"].sum()) for s in sets],
    }


CONTROLS = {"float32": {"dtype": np.float32}, "no_indels": {"indels": False}}


def solve_cli(flags: list, paths: list, control: str = None) -> dict:
    """solve() for the command-line flags of a traffic mix (-m or -x,
    -d 1, -i, and -t, whose thread count changes no result); raises on
    any flag it does not implement. control names one of CONTROLS, the
    reference computed below what the tool states."""
    rest = list(flags)
    if "-t" in rest:
        k = rest.index("-t")
        del rest[k:k + 2]
    mode = None
    for f, m in (("-m", "m"), ("-x", "x")):
        if f in rest:
            rest.remove(f)
            mode = m
    indels = "-i" in rest
    if indels:
        rest.remove("-i")
    if mode is None or rest != ["-d", "1"]:
        raise ValueError(f"the -d 1 reference does not implement {flags}")
    kw = {"indels": indels}
    kw.update(CONTROLS[control] if control else {})
    return solve(paths, mode, **kw)
