"""The reference against a brute-force count over all pairs, on tiny
-m -d 1 -i and -x -d 1 -i sets that hold every kind of near match."""

import itertools

import numpy as np
import pytest

from portbench.reference import overlap_d1

AA = "ACDEFGHIKLMNPQRSTVWY"


def near(a, b, indels):
    if len(a) == len(b):
        return sum(x != y for x, y in zip(a, b)) <= 1
    if not indels or abs(len(a) - len(b)) != 1:
        return False
    s, t = (a, b) if len(a) < len(b) else (b, a)
    return any(t[:p] + t[p + 1:] == s for p in range(len(t)))


def rows(seed, n, reps, prefix=None):
    """n rows over few genes and short lengths, many built as edits of
    others, so that every kind of match occurs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if out and rng.random() < 0.6:
            rep, sid, c, v, j, s = out[rng.integers(len(out))]
            s = list(s)
            kind = rng.integers(4)
            p = int(rng.integers(len(s)))
            if kind == 1:
                s[p] = AA[rng.integers(20)]
            elif kind == 2 and len(s) > 1:
                del s[p]
            elif kind == 3:
                s.insert(p, AA[rng.integers(20)])
            s = "".join(s)
            if rng.random() < 0.2:
                v = f"V{rng.integers(2)}"
        else:
            s = "".join(AA[k] for k in rng.integers(0, 3, rng.integers(1, 7)))
            v, j = f"V{rng.integers(2)}", f"J{rng.integers(2)}"
        rep = prefix or f"R{rng.integers(reps)}"
        out.append((rep, f"q{i}", int(rng.integers(1, 100)), v, j, s))
    return out


def write(path, rs):
    with open(path, "w") as f:
        f.write("repertoire_id\tsequence_id\tduplicate_count\tv_call\t"
                "j_call\tjunction_aa\n")
        for r in rs:
            f.write("\t".join(map(str, r)) + "\n")
    return str(path)


def brute(A, B, mode, indels):
    rows_ = sorted({r[0] for r in A}) if mode == "m" else [r[1] for r in A]
    cols = sorted({r[0] for r in B})
    m = np.zeros((len(rows_), len(cols)))
    for i, a in enumerate(A):
        for b in B:
            if a[3] == b[3] and a[4] == b[4] and near(a[5], b[5], indels):
                r = rows_.index(a[0]) if mode == "m" else i
                m[r, cols.index(b[0])] += a[2] * b[2]
    return rows_, cols, m


@pytest.mark.parametrize("seed,indels",
                         itertools.product(range(4), [True, False]))
def test_matrix_self_comparison(tmp_path, seed, indels):
    A = rows(seed, 120, 3)
    flags = ["-m", "-d", "1"] + (["-i"] if indels else [])
    got = overlap_d1.solve_cli(flags, [write(tmp_path / "a.tsv", A)])
    r, c, m = brute(A, A, "m", indels)
    assert (got["rows"], got["cols"]) == (r, c)
    np.testing.assert_array_equal(got["values"], m)
    assert got["pairs"] > len(A)


@pytest.mark.parametrize("seed", range(4))
def test_existence(tmp_path, seed):
    A = rows(seed + 10, 25, 1, prefix="Q")
    B = rows(seed + 20, 150, 4)
    B += [("R9", "x", 3, a[3], a[4], a[5]) for a in A[:5]]
    got = overlap_d1.solve_cli(
        ["-x", "-d", "1", "-i"],
        [write(tmp_path / "q.tsv", A), write(tmp_path / "b.tsv", B)])
    r, c, m = brute(A, B, "x", True)
    assert (got["rows"], got["cols"]) == (r, c)
    np.testing.assert_array_equal(got["values"], m)


def test_thread_count_changes_nothing(tmp_path):
    p = write(tmp_path / "a.tsv", rows(3, 60, 2))
    one = overlap_d1.solve_cli(["-m", "-d", "1", "-i"], [p])
    four = overlap_d1.solve_cli(["-m", "-d", "1", "-i", "-t", "4"], [p])
    np.testing.assert_array_equal(one["values"], four["values"])


def test_rejects_flags_it_does_not_implement(tmp_path):
    p = write(tmp_path / "a.tsv", rows(0, 5, 1))
    for flags in (["-m", "-d", "2"], ["-m", "-d", "1", "-g"],
                  ["-c", "-d", "1"]):
        with pytest.raises(ValueError):
            overlap_d1.solve_cli(flags, [p])
