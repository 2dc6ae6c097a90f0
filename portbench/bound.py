"""The least time the card could take for one job's matching work,
counted from the inputs and the reference's pairs, never from the
program's worklist, so that it reads the same work whatever the program
implements. Adapted from compairr_tpu_torch/bench.py dense_bound and
key_pairs (a pair's operations are one compare and one add a residue of
its shorter row).

Bytes: each input row read once (its residues at one byte each at its
own length, and 4 bytes each for its key, repertoire and count) and the
result matrix written once (8 bytes a cell). Operations: those that any
algorithm must do, one compare and one add a residue of the shorter row
of every pair the reference reports. Each over the card's published
peak: the memory rate, and the int8 operation rate, the highest the card
has, so the time is a true lower bound."""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet at its full 700 W power limit (dense int8
# tensor-core op/s, HBM3 byte/s), by the name torch gives the card
PEAKS = {"NVIDIA H100 80GB HBM3": {"ops": 1979e12, "bytes": 3.35e12}}
ROW_FIXED_BYTES = 12


def match_bound(exp: dict, card: str) -> dict:
    """The bound of one job whose reference result is exp (its input
    rows and residues, result shape, pairs and their residues), on the
    card named card. Raises for a card without published peaks."""
    if card not in PEAKS:
        raise ValueError(f"no published peaks for {card!r}")
    peak = PEAKS[card]
    n_bytes = (sum(exp["input_residues"])
               + ROW_FIXED_BYTES * sum(exp["input_rows"])
               + 8 * len(exp["rows"]) * len(exp["cols"]))
    ops = 2.0 * exp["pair_residues"]
    bytes_s = n_bytes / peak["bytes"]
    ops_s = ops / peak["ops"]
    return {
        "bound_s": max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "bytes": n_bytes, "ops": ops, "bytes_s": bytes_s, "ops_s": ops_s,
    }
