"""Run configuration.

A frozen dataclass capturing every CLI option of the reference tool
(CompAIRR src/compairr.cc:49-72,292-706), used as the single
source of truth by the io layer, the engines, and the output writers.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from .constants import (
    AA_ALPHABET_SIZE,
    NT_ALPHABET_SIZE,
    SCORE_PRODUCT,
)


@dataclass(frozen=True)
class Options:
    # commands
    matrix: bool = False
    existence: bool = False
    cluster: bool = False
    deduplicate: bool = False
    help: bool = False
    version: bool = False

    # general options
    differences: int = 0
    indels: bool = False
    ignore_counts: bool = False
    ignore_genes: bool = False
    nucleotides: bool = False
    ignore_unknown: bool = False
    ignore_empty: bool = False
    score_int: int = SCORE_PRODUCT
    score_string: Optional[str] = None
    threads: int = 1

    # io options
    alternative: bool = False
    cdr3: bool = False
    distance: bool = False
    keep_columns: Optional[str] = None
    log: Optional[str] = None
    output: str = "-"
    no_matrix: bool = False
    pairs: Optional[str] = None

    # positional inputs
    input1: Optional[str] = None
    input2: Optional[str] = None

    # parsed keep-columns names (derived from keep_columns)
    keep_columns_names: tuple[str, ...] = field(default_factory=tuple)

    @property
    def alphabet_size(self) -> int:
        return NT_ALPHABET_SIZE if self.nucleotides else AA_ALPHABET_SIZE

    @property
    def seq_header(self) -> str:
        """Name of the sequence column in use (compairr.cc:696-705)."""
        if self.cdr3:
            return "cdr3" if self.nucleotides else "cdr3_aa"
        return "junction" if self.nucleotides else "junction_aa"

    def with_(self, **kw) -> "Options":
        return replace(self, **kw)


# host-side worker count for the current run (-t/--threads): the native
# parser shards its input by line ranges and the native grouping passes
# insert with CAS — both bit-identical for any count. Set by cli.main;
# library users call set_runtime_threads directly.
_runtime_threads = 1


def set_runtime_threads(n: int) -> None:
    global _runtime_threads
    _runtime_threads = max(1, int(n))


def runtime_threads() -> int:
    return _runtime_threads
