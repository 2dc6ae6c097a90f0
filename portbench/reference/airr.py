"""A plain AIRR TSV parse for the reference: the columns the generator
writes (repertoire_id, sequence_id, duplicate_count, v_call, j_call,
junction_aa), one line a row, read with NumPy alone. It imports nothing
of the program under test.

Returns a dict: seqs uint8 [n, W] (residue codes 0..19, pad 255),
lengths int64, counts int64, rep / v / j (str arrays, one a row),
seq_ids (str array, or None).
"""

from __future__ import annotations

import numpy as np

AA_CHARS = b"ACDEFGHIKLMNPQRSTVWY"
PAD = 255
_CODE = np.full(256, PAD, dtype=np.uint8)
_CODE[np.frombuffer(AA_CHARS, dtype=np.uint8)] = np.arange(20)


def _field(buf: np.ndarray, start: np.ndarray, end: np.ndarray,
           fill: int = 0) -> np.ndarray:
    """uint8 [n, max width] of buf[start:end] a row, `fill` past the end:
    each row's window of the buffer copied whole, then masked."""
    width = int((end - start).max()) if len(start) else 0
    padded = np.concatenate([buf, np.zeros(width, dtype=np.uint8)])
    rows = np.lib.stride_tricks.sliding_window_view(padded, width)[start]
    inside = np.arange(width)[None, :] < (end - start)[:, None]
    return np.where(inside, rows, np.uint8(fill))


def _strings(buf, start, end) -> np.ndarray:
    """The fields as a bytes array, one a row."""
    f = _field(buf, start, end)
    if not f.shape[1]:
        return np.full(len(start), b"", dtype="S1")
    return np.ascontiguousarray(f).view(f"S{f.shape[1]}").ravel()


def read(path: str) -> dict:
    with open(path, "rb") as fh:
        data = fh.read()
    head, _, body = data.partition(b"\n")
    names = head.decode().split("\t")
    buf = np.frombuffer(body, dtype=np.uint8)
    ends = np.flatnonzero(buf == ord("\n"))
    n = len(ends)
    if n and ends[-1] != len(buf) - 1:
        raise ValueError(f"{path}: last line has no newline")
    tabs = np.flatnonzero(buf == ord("\t"))
    ncol = len(names)
    if len(tabs) != n * (ncol - 1):
        raise ValueError(f"{path}: not {ncol} fields on every line")
    tabs = tabs.reshape(n, ncol - 1)
    starts = np.concatenate([[0], ends[:-1] + 1])[:n].astype(np.int64)
    if n and not ((tabs > starts[:, None]).all()
                  and (tabs < ends[:, None]).all()):
        raise ValueError(f"{path}: tabs out of line")
    lo = np.concatenate([starts[:, None], tabs + 1], axis=1)
    hi = np.concatenate([tabs, ends[:, None]], axis=1)
    col = {name: (lo[:, i], hi[:, i]) for i, name in enumerate(names)}

    s, e = col["junction_aa"]
    seqs = _CODE[_field(buf, s, e, fill=ord("\n"))]
    lengths = (e - s).astype(np.int64)
    inside = np.arange(seqs.shape[1])[None, :] < lengths[:, None]
    if (seqs[inside] == PAD).any():
        raise ValueError(f"{path}: a residue outside the 20 amino acids")

    s, e = col["duplicate_count"]
    digits = _field(buf, s, e, fill=ord("0")).astype(np.int64) - ord("0")
    if (digits < 0).any() or (digits > 9).any() or ((e - s) < 1).any():
        raise ValueError(f"{path}: duplicate_count is not a whole number")
    width = digits.shape[1]
    # right-align: a field of w digits has (width - w) zeros after it
    shift = (width - (e - s)).astype(np.int64)
    counts = (digits * 10 ** (width - 1 - np.arange(width))[None, :]).sum(1)
    counts = counts // 10 ** shift

    out = {
        "seqs": seqs, "lengths": lengths, "counts": counts,
        "rep": _strings(buf, *col["repertoire_id"]),
        "v": _strings(buf, *col["v_call"]),
        "j": _strings(buf, *col["j_call"]),
        "seq_ids": (_strings(buf, *col["sequence_id"])
                    if "sequence_id" in col else None),
    }
    return out
