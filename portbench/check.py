"""The comparison that decides `correct`: a job's output file, cell by
cell, against the text that the reference's result gives in the tool's
matrix layout (a header "#" and the column labels, then one line a row:
its label and its values as C's %.10g prints them, tab-separated)."""

from __future__ import annotations


def expected_cells(exp: dict) -> list:
    lines = [["#"] + list(exp["cols"])]
    for label, row in zip(exp["rows"], exp["values"]):
        lines.append([label] + [f"{float(v):.10g}" for v in row])
    return lines


def cells_off(text: str, want: list) -> int:
    """Cells of `text` (lines of tab-separated cells) that differ from
    `want`, a missing or extra cell counting as one that differs."""
    got = [line.split("\t") for line in text.split("\n")]
    if got and got[-1] == [""]:
        got.pop()
    off = 0
    for i in range(max(len(got), len(want))):
        g = got[i] if i < len(got) else []
        w = want[i] if i < len(want) else []
        off += sum(1 for k in range(max(len(g), len(w)))
                   if k >= len(g) or k >= len(w) or g[k] != w[k])
    return off
