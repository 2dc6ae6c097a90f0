"""Alphabets, residue encodings, and score-mode constants.

Semantics mirror the reference CompAIRR encoding tables
(CompAIRR src/db.cc:33-74): amino acids A..Y map to 0..19 (both
cases accepted), nucleotides map a/A=0, c/C=1, g/G=2, t/T/u/U=3. All
other bytes are "unknown symbols". Here the tables are built
programmatically as numpy lookup arrays so whole columns of residues
can be encoded vectorised.
"""

from __future__ import annotations

import numpy as np

AA_CHARS = "ACDEFGHIKLMNPQRSTVWY"
NT_CHARS = "acgt"

AA_ALPHABET_SIZE = 20
NT_ALPHABET_SIZE = 4

UNKNOWN = -1  # encoding for unmapped symbols


def _build_map(pairs: list[tuple[str, int]]) -> np.ndarray:
    table = np.full(256, UNKNOWN, dtype=np.int8)
    for ch, code in pairs:
        table[ord(ch)] = code
        table[ord(ch.swapcase())] = code
    return table


MAP_AA = _build_map([(c, i) for i, c in enumerate(AA_CHARS)])
MAP_NT = _build_map(
    [("a", 0), ("c", 1), ("g", 2), ("t", 3), ("u", 3)]
)

# Decoding tables (code -> output character). Amino acids print upper
# case, nucleotides lower case, as in the reference
# (CompAIRR src/db.cc:73-74, db_fprint_sequence db.cc:1035-1049).
DECODE_AA = np.frombuffer(AA_CHARS.encode(), dtype=np.uint8)
DECODE_NT = np.frombuffer(NT_CHARS.encode(), dtype=np.uint8)

# Score modes; names/order mirror CompAIRR src/compairr.h:125-135.
SCORE_PRODUCT = 0
SCORE_RATIO = 1
SCORE_MIN = 2
SCORE_MAX = 3
SCORE_MEAN = 4
SCORE_MH = 5
SCORE_JACCARD = 6

SCORE_OPTIONS = ["Product", "Ratio", "Min", "Max", "Mean", "MH", "Jaccard"]

SCORE_DESCR = [
    "Sum of products of counts",
    "Sum of ratios of counts",
    "Sum of minimum of counts",
    "Sum of maximum of counts",
    "Sum of mean of counts",
    "Morisita-Horn index",
    "Jaccard index",
]

MAX_THREADS = 256

# Maximum d handled by the reference's variant-hashing scheme
# (CompAIRR src/compairr.h:113). Our grid engine handles all
# d uniformly, but the constant still gates which log phases appear.
MAXDIFF_HASH = 2
