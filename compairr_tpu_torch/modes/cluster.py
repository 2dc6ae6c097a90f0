"""Clustering (-c / --cluster).

Single-linkage clustering at the fixed distance threshold, mirroring
CompAIRR src/cluster.cc:301-475. The reference builds a
neighbour network per sequence (multi-threaded) and then BFS-labels
clusters serially via an intrusive linked list; output lists clusters
by decreasing size, members in BFS discovery order.

Here the match grid comes from the grid engine (self-comparison,
self-pairs excluded, repertoire ignored — cluster.cc:105). To
reproduce the reference's member order byte-for-byte, each seed's
neighbour list is sorted by the canonical variant enumeration order
(core/variant_order.py) before the BFS, which is what the reference's
network arrays contain. Ties between equal-sized clusters keep
creation (seed) order, matching glibc's stable qsort behaviour.
"""

from __future__ import annotations

from typing import IO

import numpy as np

from ..config import Options
from ..constants import MAXDIFF_HASH
from ..core.db import GeneTables
from ..core.variant_order import variant_sort_keys
from ..io.airr import read_db
from ..utils.progress import Logger


def cluster(opt: Options, logger: Logger, outfile: IO[str],
            devices=None) -> None:
    from ..io.card import job_on_card
    from ..ops.engine import MatchSpec, card_route, find_pairs

    # a job on the tile route may parse its file on the card (io/card.py)
    job_on_card(card_route(MatchSpec(
        differences=opt.differences, indels=opt.indels,
        ignore_genes=opt.ignore_genes, exclude_self=True)))
    logger.write("Immune receptor repertoire clustering\n\n")

    genes = GeneTables()
    d = read_db(opt.input1, opt, genes, logger, False, "1")
    n = d.n

    logger.write("\n")
    logger.write(f"Unique V genes:    {len(genes.v_names)}\n")
    logger.write(f"Unique J genes:    {len(genes.j_names)}\n")
    logger.write("\n")

    if opt.differences <= MAXDIFF_HASH:
        logger.progress_init("Computing hashes: ", n)
        logger.progress_update(n)
        logger.progress_done()

    logger.progress_init("Hashing sequences:", n)
    logger.progress_update(n)
    logger.progress_done()

    spec = MatchSpec(
        differences=opt.differences,
        indels=opt.indels,
        ignore_genes=opt.ignore_genes,
        exclude_self=True,
    )
    if opt.differences > 0:
        # approximate matching never reads the parse-time row hashes
        d.drop_row_hash()
    idx1, idx2, _dist = find_pairs(
        d, d, spec, logger, "Building network: ", want_dist=False,
        devices=devices,
    )

    # per-seed adjacency in canonical variant order (the order the
    # reference's network[] arrays hold hits, cluster.cc:225-274); at
    # d>2 the brute-force scan collects hits in set-2 index order
    # (process_trad, cluster.cc:165-211)
    if len(idx1) and opt.differences <= MAXDIFF_HASH:
        keys = variant_sort_keys(
            d.seqs, d.lengths, d.seqs, d.lengths, idx1, idx2
        )
        perm = np.lexsort(
            (idx2, keys[:, 4], keys[:, 3], keys[:, 2], keys[:, 1],
             keys[:, 0], idx1)
        )
        src = idx1[perm]
        dst = idx2[perm]
    elif len(idx1):
        perm = np.lexsort((idx2, idx1))
        src = idx1[perm]
        dst = idx2[perm]
    else:
        src = idx1
        dst = idx2

    # CSR adjacency
    deg = np.bincount(src, minlength=n).astype(np.int64)
    adj_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_start[1:])

    # BFS via linked chain (cluster.cc:279-417); the C++ BFS is the
    # same algorithm at native speed, the Python loop below is the
    # executable specification and fallback
    from ..io.native import cluster_bfs_native

    logger.progress_init("Clustering:       ", n)
    NO = -1
    clusterid = np.full(n, NO, dtype=np.int64)
    nxt = np.full(n, NO, dtype=np.int64)
    native = cluster_bfs_native(adj_start, dst, clusterid, nxt)
    if native is not None:
        cluster_seeds, cluster_sizes = native
        logger.progress_update(n)
    else:
        cluster_seeds = []
        cluster_sizes = []
        x = 0
        for seed in range(n):
            if clusterid[seed] != NO:
                continue
            cid = len(cluster_seeds)
            clusterid[seed] = cid
            tail = seed
            size = 0
            member = seed
            while member != NO:
                size += 1
                for e in range(adj_start[member], adj_start[member + 1]):
                    hit = dst[e]
                    if clusterid[hit] == NO:
                        clusterid[hit] = cid
                        nxt[tail] = hit
                        tail = hit
                x += 1
                logger.progress_update(x)
                member = nxt[member]
            cluster_seeds.append(seed)
            cluster_sizes.append(size)
        cluster_seeds = np.asarray(cluster_seeds, dtype=np.int64)
        cluster_sizes = np.asarray(cluster_sizes, dtype=np.int64)
    logger.progress_done()

    clustercount = len(cluster_seeds)

    # sort clusters by size descending, stable (cluster.cc:53-63,421-423)
    logger.progress_init("Sorting clusters: ", clustercount)
    order = np.argsort(-cluster_sizes, kind="stable")
    logger.progress_done()

    # write clusters (cluster.cc:427-455)
    logger.progress_init("Writing clusters: ", n)
    outfile.write(
        "#cluster_no\tcluster_size\trepertoire_id\tsequence_id\t"
        f"duplicate_count\tv_call\tj_call\t{opt.seq_header}\n"
    )
    from ..io.native import write_cluster_native

    if write_cluster_native(
        outfile, d, order, cluster_sizes, cluster_seeds, nxt
    ):
        logger.progress_update(n)
        logger.progress_done()
        logger.write("\n")
        logger.write(f"Clusters:          {clustercount}\n")
        return

    written = 0
    buf: list = []
    for out_no, c in enumerate(order, start=1):
        size = cluster_sizes[c]
        a = cluster_seeds[c]
        while a != NO:
            buf.append(
                f"{out_no}\t{size}\t"
                f"{d.repertoire_ids[d.rep_no[a]]}\t"
                f"{d.sequence_id_str(a)}\t"
                f"{int(d.counts[a])}\t"
                f"{d.v_name(a)}\t{d.j_name(a)}\t"
                f"{d.sequence_str(a)}\n"
            )
            written += 1
            a = int(nxt[a]) if nxt[a] != NO else NO
            if len(buf) >= (1 << 18):
                outfile.write("".join(buf))
                buf.clear()
                logger.progress_update(written)
    outfile.write("".join(buf))
    logger.progress_update(written)
    logger.progress_done()

    logger.write("\n")
    logger.write(f"Clusters:          {clustercount}\n")
