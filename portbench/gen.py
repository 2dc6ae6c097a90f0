"""The frozen input generator: repertoire sets from a configuration's
parameters and a seed, and the AIRR TSV writer.

A set is a dict of numpy arrays and name lists:
  seqs int8 [n, W] (residue codes 0..19, pad 20), lengths int32,
  counts int64, rep_no / v_no / j_no int32, rep_names / v_names /
  j_names (lists of str).

The cohort draw is a frozen copy of compairr_tpu_torch/bench.py
synth_arrays (itself the JAX package's generator): with gene_skew 0 it
gives the same rows at the same seed, which a test holds. The planting
steps are frozen copies of bench.py _plant_near_dups (one substitution)
and chip_smoke.py with_planted (one indel), on these dicts; a set that
names plant_substitution2 gets a third step of the harness's own (two
substitutions).
"""

from __future__ import annotations

import numpy as np

AA_CHARS = "ACDEFGHIKLMNPQRSTVWY"
PAD = 20
ALPHA = 20


def gene_draw(rng, n_genes: int, n: int, skew: float) -> np.ndarray:
    """Gene numbers of n rows: uniform (skew 0, as synth_arrays draws
    them), else Zipf with exponent skew, gene k taking weight
    1 / (k + 1) ** skew."""
    if skew == 0:
        return rng.integers(0, n_genes, size=n).astype(np.int32)
    w = 1.0 / np.arange(1, n_genes + 1, dtype=np.float64) ** skew
    return rng.choice(n_genes, size=n, p=w / w.sum()).astype(np.int32)


def cohort(p: dict, seed: int) -> dict:
    """The cohort's rows before planting. Copied from
    compairr_tpu_torch/bench.py synth_arrays: the same draws in the same
    order (lengths, residues, counts, repertoires, V, J), the genes
    through gene_draw."""
    rng = np.random.default_rng(seed)
    n = int(p["rows"])
    lengths = np.clip(
        np.round(rng.normal(p["length_mean"], p["length_sd"], size=n)),
        p["length_min"],
        p["length_max"],
    ).astype(np.int32)
    lmax = int(lengths.max())
    seqs = np.full((n, lmax), PAD, dtype=np.int8)
    mask = np.arange(lmax)[None, :] < lengths[:, None]
    vals = rng.integers(0, ALPHA, size=(n, lmax), dtype=np.int8)
    seqs[mask] = vals[mask]
    counts = rng.integers(1, 100, size=n).astype(np.int64)
    rep_no = rng.integers(0, p["repertoires"], size=n).astype(np.int32)
    v_no = gene_draw(rng, p["v_genes"], n, p["gene_skew"])
    j_no = gene_draw(rng, p["j_genes"], n, p["gene_skew"])
    return {
        "seqs": seqs, "lengths": lengths, "counts": counts,
        "rep_no": rep_no, "v_no": v_no, "j_no": j_no,
        "rep_names": [f"R{r:03d}" for r in range(p["repertoires"])],
        "v_names": [f"TRBV{k}" for k in range(p["v_genes"])],
        "j_names": [f"TRBJ{k}" for k in range(p["j_genes"])],
    }


def plant_substitutions(s: dict, frac: float, seed: int,
                        first: int) -> None:
    """Copy about frac of the set's rows over others of the same set with
    one substitution in the first `first` residues (the shortest length),
    in place. Copied from compairr_tpu_torch/bench.py _plant_near_dups
    (source and target the same set; its LEN_LO, 9, is `first`)."""
    rng = np.random.default_rng(seed)
    n = len(s["lengths"])
    k = max(int(n * frac), 1)
    src = rng.choice(n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    s["seqs"][dst] = s["seqs"][src]
    s["lengths"][dst] = s["lengths"][src]
    s["v_no"][dst] = s["v_no"][src]
    s["j_no"][dst] = s["j_no"][src]
    pos = rng.integers(0, first, size=k)
    s["seqs"][dst, pos] = (s["seqs"][dst, pos] + 1) % ALPHA


def plant_substitutions2(s: dict, frac: float, seed, first: int) -> None:
    """Copy about frac of the set's rows over others of the same set (V,
    J and length with them) with two substitutions at two distinct
    positions in the first `first` residues, each to another residue, in
    place: each planted pair is exactly two substitutions apart. src and
    dst are drawn as plant_substitutions draws them. A row shorter than
    `first` (a deletion planted into a row of the shortest length) takes
    its positions among its own residues."""
    rng = np.random.default_rng(seed)
    n = len(s["lengths"])
    k = max(int(n * frac), 1)
    src = rng.choice(n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    span = np.minimum(s["lengths"][src], first).astype(np.int64)
    if span.min() < 2:
        raise ValueError("two substitutions need rows of 2 residues")
    s["seqs"][dst] = s["seqs"][src]
    s["lengths"][dst] = s["lengths"][src]
    s["v_no"][dst] = s["v_no"][src]
    s["j_no"][dst] = s["j_no"][src]
    p1 = rng.integers(0, span)
    p2 = (p1 + rng.integers(1, span)) % span
    for pos in (p1, p2):
        step = rng.integers(1, ALPHA, size=k)
        s["seqs"][dst, pos] = (s["seqs"][dst, pos] + step) % ALPHA


def _edit(row: list, kind: int, rng) -> list:
    """One edit of chip_smoke.py with_planted: 0 substitution, 1
    deletion, 2 insertion, at a random position."""
    pos = int(rng.integers(0, len(row)))
    if kind == 0:
        row[pos] = (row[pos] + int(rng.integers(1, ALPHA))) % ALPHA
    elif kind == 1 and len(row) > 1:
        del row[pos]
    else:
        row.insert(pos, int(rng.integers(0, ALPHA)))
    return row


def _widened(seqs: np.ndarray, width: int) -> np.ndarray:
    if seqs.shape[1] >= width:
        return seqs
    out = np.full((seqs.shape[0], width), PAD, dtype=np.int8)
    out[:, : seqs.shape[1]] = seqs
    return out


def plant_indels(s: dict, frac: float, seed: int) -> None:
    """Replace about frac of the set's rows by copies of other rows of
    the same set with one deletion or insertion (same V and J, length
    +-1), one residue wider so that an insertion fits, in place. Copied
    from chip_smoke.py with_planted with kinds (1, 2) and source and
    target the same set."""
    rng = np.random.default_rng(seed)
    n = len(s["lengths"])
    k = max(int(n * frac), 1)
    src = rng.choice(n, size=k, replace=False)
    dst = rng.choice(n, size=k, replace=False)
    kind = rng.choice(np.asarray((1, 2)), size=k)
    old = s["seqs"]
    seqs = _widened(old, old.shape[1] + 1)
    lengths = s["lengths"].copy()
    v_no, j_no = s["v_no"].copy(), s["j_no"].copy()
    for a, t, kd in zip(src, dst, kind):
        row = _edit(old[a, : s["lengths"][a]].tolist(), int(kd), rng)
        seqs[t] = PAD
        seqs[t, : len(row)] = row
        lengths[t] = len(row)
        v_no[t], j_no[t] = s["v_no"][a], s["j_no"][a]
    s.update(seqs=seqs, lengths=lengths, v_no=v_no, j_no=j_no)


def make_sets(config: dict, seed: int) -> dict:
    """Every set of a configuration (config["sets"], in order) from one
    seed: the cohort's rows from the seed itself, each later step from
    (seed, step number); the two-substitution step only where the set
    names plant_substitution2. Rows are then grouped by repertoire, as
    in a cohort's files put one after another."""
    out: dict = {}
    for name, p in config["sets"].items():
        if p["kind"] == "cohort":
            s = cohort(p, seed)
            plant_substitutions(s, p["plant_substitution"], [seed, 1],
                                p["length_min"])
            plant_indels(s, p["plant_indel"], [seed, 2])
            if "plant_substitution2" in p:
                plant_substitutions2(s, p["plant_substitution2"],
                                     [seed, 3], p["length_min"])
        else:
            raise ValueError(f"set {name}: unknown kind {p['kind']!r}")
        out[name] = s
    for s in out.values():
        by_rep = np.argsort(s["rep_no"], kind="stable")
        for k in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no"):
            s[k] = s[k][by_rep]
    return out


def _fixed(strings: list) -> np.ndarray:
    """uint8 [len, width] of the ASCII strings, zero-padded."""
    a = np.array([x.encode() for x in strings])
    return a.view(np.uint8).reshape(len(strings), a.dtype.itemsize)


def tsv_bytes(s: dict, columns: list) -> bytes:
    """The set as an AIRR TSV (header, then one line a row, in the
    set's row order), built as one byte matrix with zero padding that is
    squeezed out at the end."""
    n = len(s["lengths"])
    letters = np.zeros(256, dtype=np.uint8)
    letters[:ALPHA] = np.frombuffer(AA_CHARS.encode(), dtype=np.uint8)
    fields = {
        "repertoire_id": lambda: _fixed(s["rep_names"])[s["rep_no"]],
        "duplicate_count": lambda: _fixed(
            [str(c) for c in range(int(s["counts"].max()) + 1)]
        )[s["counts"]],
        "v_call": lambda: _fixed(s["v_names"])[s["v_no"]],
        "j_call": lambda: _fixed(s["j_names"])[s["j_no"]],
        "junction_aa": lambda: letters[s["seqs"].astype(np.uint8)],
    }
    sep = np.full((n, 1), ord("\t"), dtype=np.uint8)
    parts = []
    for c in columns:
        parts += [fields[c](), sep]
    parts[-1] = np.full((n, 1), ord("\n"), dtype=np.uint8)
    body = np.concatenate(parts, axis=1)
    return ("\t".join(columns) + "\n").encode() + body[body != 0].tobytes()


def write_tsv(s: dict, columns: list, path: str) -> None:
    with open(path, "wb") as f:
        f.write(tsv_bytes(s, columns))
