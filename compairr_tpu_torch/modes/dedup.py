"""Deduplication (--deduplicate / -z).

Merges entries in the same repertoire with identical sequences and
identical V/J genes (unless -g), summing duplicate counts (or counting
entries with -f). Output preserves the input order of first
occurrences, matching CompAIRR src/dedup.cc:27-215.

The reference walks a hash table chain per sequence; here grouping is
one vectorised exact-match pass (core/exact.py) and the aggregation is
two bincounts.
"""

from __future__ import annotations

from typing import IO

import numpy as np

from ..config import Options
from ..core.db import GeneTables, SeqDB
from ..core.exact import group_ids
from ..io.airr import read_db
from ..utils.progress import Logger


def dedup(opt: Options, logger: Logger, outfile: IO[str]) -> SeqDB:
    genes = GeneTables()
    db = read_db(opt.input1, opt, genes, logger, False, "1")

    logger.write(f"Unique V genes:    {len(genes.v_names)}\n")
    logger.write(f"Unique J genes:    {len(genes.j_names)}\n")

    n = db.n

    # group-key construction is our analogue of Zobrist hashing
    logger.progress_init("Computing hashes: ", n)
    groups, n_groups = group_ids(
        db, include_genes=not opt.ignore_genes, include_rep=True
    )
    logger.progress_update(n)
    logger.progress_done()

    outfile.write("repertoire_id\tduplicate_count")
    if not opt.ignore_genes:
        outfile.write("\tv_call\tj_call")
    outfile.write(f"\t{opt.seq_header}\n")

    logger.progress_init("Deduplicating:    ", n)
    if opt.ignore_counts:
        merged = np.bincount(groups, minlength=n_groups).astype(np.int64)
    else:
        merged = np.bincount(
            groups, weights=db.counts.astype(np.float64), minlength=n_groups
        ).astype(np.int64)
    dup_seq = n - n_groups
    logger.progress_update(n)
    logger.progress_done()

    logger.write(f"Duplicates merged: {dup_seq}\n")

    # first occurrence index of each group (groups are numbered in
    # first-occurrence order, so a reverse stable pass suffices)
    first = np.full(n_groups, -1, dtype=np.int64)
    first[groups[::-1]] = np.arange(n - 1, -1, -1)

    logger.progress_init("Writing output:   ", n)
    from ..io.native import write_dedup_native

    if write_dedup_native(
        outfile, db, first, merged, include_genes=not opt.ignore_genes
    ):
        logger.progress_update(n)
        logger.progress_done()
        logger.write("\n")
        return db

    chunk = 1 << 18
    for g0 in range(0, n_groups, chunk):
        gs = range(g0, min(g0 + chunk, n_groups))
        if opt.ignore_genes:
            outfile.write(
                "".join(
                    f"{db.repertoire_ids[db.rep_no[i]]}\t{int(merged[g])}\t"
                    f"{db.sequence_str(i)}\n"
                    for g, i in ((g, int(first[g])) for g in gs)
                )
            )
        else:
            outfile.write(
                "".join(
                    f"{db.repertoire_ids[db.rep_no[i]]}\t{int(merged[g])}\t"
                    f"{db.v_name(i)}\t{db.j_name(i)}\t"
                    f"{db.sequence_str(i)}\n"
                    for g, i in ((g, int(first[g])) for g in gs)
                )
            )
        logger.progress_update(min(g0 + chunk, n_groups))
    logger.progress_done()

    logger.write("\n")
    return db
