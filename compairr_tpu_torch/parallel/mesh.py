"""Multi-device distribution of the dense overlap matrix, on torch.distributed.

Port of compairr_tpu/parallel/mesh.py. Set 1's key-sorted rows are cut
into contiguous spans, the shards, over a list of devices and, in a
multi-process run, over ranks: the global shards are world size x
len(devices), and rank r runs shards r*L .. r*L + L - 1. Every rank holds
the full host copy of both sets and plans the whole run once
(engine.dense_plan), so every shard takes the same kernel, key width and
sum type. Both sets are derived once (engine.dense_side), each shard's
span is cut from set 1's derived rows on the device (engine.side_span),
and each shard runs the port's own dense kernel on it
(engine.dense_span). The [R1, R2] partial sums meet
on the first local device, then in one all_reduce across ranks, which
stands in for JAX's psum. dense_matrix_ring shards set 2 too and passes
its shards round the ring: JAX's ppermute becomes a move to the next
device in one process and batch_isend_irecv between ranks.

A device list may repeat a device ([cpu] * 8 in the CPU tests,
[cuda:0] * 4 on one card): its shards then share one copy of set 2, and
a hand-off to it copies nothing.

Not carried over: JAX's float32 exactness guard with its chunk plan
(_plan_sharded_chunks), and the ring's delegation to the sharded path
that the guard forced. The partial sums here are int64, or float64 for
ratio and where a cell of the whole run could reach 2^62 (the plan's
bound covers every partial), so they are exact in any order and there
is nothing to guard; ratio sums differ from one device's in rounding
only. No worklist is padded to a common length either: there is no
SPMD program, and each shard launches its own.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.db import SeqDB
from ..ops import engine as E
from ..ops.engine import TILE_M, TILE_N, MatchSpec

# Phase and tile statistics of the last dense_matrix_sharded (or ring)
# call, with JAX's keys for its weak-scaling script, plus `backend`
# ("none" in one process) and `allreduce_s`.
LAST_STATS: dict = {}

# worklist tiles a shard at least when dense_matrix_sharded picks its own
# devices, as a CLI run does. A one-shot process pays about 0.8-1.0 s for
# the first use of its other cards (one H100 against four, chip_smoke.py
# phase 21), which a tile's 0.3 us of kernel time repays only from about
# 2^20 tiles a card on
DENSE_TILES_PER_SHARD_MIN = 1 << 20


def _ranks_per_host() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def rank_devices(device=None) -> list:
    """This rank's devices: utils.device.local_devices, shared between
    the ranks of one host (LOCAL_WORLD_SIZE and LOCAL_RANK, as torchrun
    sets them) in equal slices while the host has a device a rank, else
    one device each, which several ranks then share."""
    from ..utils import device as D

    devs = D.local_devices(device)
    per_host = _ranks_per_host()
    if per_host <= 1 or devs[0].type == "cpu":
        return devs
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if len(devs) < per_host:
        return [devs[local_rank % len(devs)]]
    k = len(devs) // per_host
    return devs[local_rank * k : (local_rank + 1) * k]


def choose_backend(device=None) -> str:
    """nccl when every rank of this host has CUDA devices of its own;
    gloo on the CPU, and when ranks share a card (NCCL refuses two ranks
    on one device)."""
    from ..utils import device as D

    devs = D.local_devices(device)
    if devs[0].type == "cuda" and len(devs) >= _ranks_per_host():
        return "nccl"
    return "gloo"


def _local_ranks(store, rank: int, world_size: int) -> None:
    """LOCAL_RANK and LOCAL_WORLD_SIZE, as torchrun sets them, for a
    rendezvous that did not set them (COMPAIRR_DISTRIBUTED's tcp://
    form): the ranks that give this host's name, in rank order, through
    the rendezvous store. Values already in the environment stay."""
    import socket

    host = socket.gethostname()
    store.set(f"compairr_host/{rank}", host)
    hosts = [store.get(f"compairr_host/{r}").decode()
             for r in range(world_size)]
    same = [r for r, h in enumerate(hosts) if h == host]
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(len(same)))
    os.environ.setdefault("LOCAL_RANK", str(same.index(rank)))


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> Optional[str]:
    """Join the process group of a multi-process run, after which every
    rank's devices form the global shard list. The parameters default to
    torch's environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK,
    as torchrun sets them); COMPAIRR_DISTRIBUTED asks for the same, and
    when it holds a URL (tcp://host:port) it names the rendezvous. With
    none of them set and no parameter, a single-process run: nothing is
    done and None returned. The ranks meet first, and those without
    LOCAL_RANK and LOCAL_WORLD_SIZE take them from the ranks on their
    host (_local_ranks), so that ranks sharing a host share its cards
    (rank_devices). The backend, unless given, is then choose_backend()'s,
    printed to stderr and returned; a failure raises and no other backend
    is tried."""
    env = os.environ
    if (
        init_method is None
        and world_size is None
        and rank is None
        and "MASTER_ADDR" not in env
        and not env.get("COMPAIRR_DISTRIBUTED")
    ):
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if init_method is None:
        url = env.get("COMPAIRR_DISTRIBUTED", "")
        init_method = url if "://" in url else "env://"
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    store, rank, world_size = next(dist.rendezvous(init_method, rank,
                                                   world_size))
    _local_ranks(store, rank, world_size)
    backend = backend or choose_backend()
    if backend == "nccl":  # the rank's own first card
        torch.cuda.set_device(rank_devices()[0])
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store),
        world_size=world_size, rank=rank,
    )
    print(
        f"compairr_tpu_torch: rank {rank} of {world_size}, "
        f"torch.distributed backend {backend}",
        file=sys.stderr, flush=True,
    )
    return backend


def world() -> tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _backend_name() -> str:
    return dist.get_backend() if world()[0] > 1 else "none"


def _devices(devices: Optional[Sequence]) -> list:
    """The local shard devices: `devices` (a CUDA device without an
    index is the current one), else rank_devices()."""
    from ..utils.device import resolve_device

    if devices is None:
        return rank_devices()
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded run needs at least one device")
    return [
        torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and d.index is None else d
        for d in devs
    ]


def _check_shards(n_local: int, n_world: int) -> None:
    """Every rank must run as many shards: each works out the global
    layout from its own count. Raises, on every rank, when they
    differ."""
    if n_world == 1:
        return
    counts: list = [None] * n_world
    dist.all_gather_object(counts, n_local)
    if len(set(counts)) > 1:
        raise ValueError(
            f"the ranks run different numbers of local shards {counts}; "
            "give every rank as many devices (COMPAIRR_DEVICES, devices=)"
        )


def _sync(devs: list) -> None:
    for d in set(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _equal_span_bounds(n: int, n_shards: int):
    per = -(-n // n_shards) if n else 0
    return [
        (min(k * per, n), min(min(k * per, n) + per, n))
        for k in range(n_shards)
    ]


def _balanced_bounds(plan: E.DensePlan, n: int, n_shards: int):
    """Contiguous block-aligned set-1 row spans with about equal worklist
    tile counts a shard. Equal row spans give shards tile counts that
    diverge with the length and gene distribution of the sorted rows,
    and every shard then waits for the busiest; cuts at the quantiles of
    the cumulative tile counts of the row blocks (plan.work, the whole
    run's worklist) balance the work instead. Cuts stay on tile_m block
    boundaries, so each shard's blocks are the whole run's blocks and its
    worklist holds exactly their tiles. Below 4 blocks a shard, equal row
    spans (each shard then packs its own, finer blocks)."""
    tile_m = plan.tile_m
    nblocks = max(plan.npad_a // tile_m, 1)
    if nblocks < 4 * n_shards or len(plan.work) == 0:
        return _equal_span_bounds(n, n_shards)
    counts = np.bincount(plan.work[:, 0] // tile_m, minlength=nblocks)
    prefix = np.cumsum(counts)
    total = int(prefix[-1])
    cuts = [0]
    for k in range(1, n_shards):
        cut = int(np.searchsorted(prefix, total * k / n_shards,
                                  side="left")) + 1
        cuts.append(max(min(cut, nblocks), cuts[-1]))
    cuts.append(nblocks)
    return [
        (
            min(cuts[k] * tile_m, n),
            n if k == n_shards - 1 else min(cuts[k + 1] * tile_m, n),
        )
        for k in range(n_shards)
    ]


def _span_rows(bounds, tile: int) -> int:
    """One padded row count for every span of a side (the longest span
    and one all-pad tile), so that all its shards have the same shapes."""
    span = max((hi - lo for lo, hi in bounds), default=0)
    return E._round_up(span, tile) + tile


class _Sums:
    """The run's partial sums, one accumulator a distinct device."""

    def __init__(self, plan: E.DensePlan):
        self.dtype = torch.float64 if plan.float_out else torch.int64
        self.shape = (plan.r1p, plan.r2p)
        self.acc: dict = {}

    def add(self, part: torch.Tensor) -> None:
        """Add a kernel's fresh result (kept as the device's accumulator
        when it is the first there)."""
        if part.device in self.acc:
            self.acc[part.device] += part
        else:
            self.acc[part.device] = part

    def total(self, dev) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=dev)
        for part in self.acc.values():
            out += part.to(dev)
        return out


def _all_reduce(total: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's total (JAX's psum), through the host under
    gloo, which reduces CPU tensors."""
    if dist.get_backend() == "gloo" and total.device.type != "cpu":
        total = total.cpu()
    dist.all_reduce(total)
    return total


def dense_matrix_sharded(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    devices: Optional[Sequence] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
) -> np.ndarray:
    """[R1, R2] overlap matrix with set 1 cut into row spans over the
    global shards (balanced by worklist tiles unless
    COMPAIRR_SHARD_BALANCE=0) and set 2 whole on each distinct device.
    Both sets are derived once, on the first device: each span is cut
    from set 1's rows there and set 2 is copied. The shards are each
    rank's `devices`, every one of them; by default rank_devices(), as
    many as the whole run's worklist gives DENSE_TILES_PER_SHARD_MIN
    tiles each (at least one a rank), since another card's first use
    costs more than its share of a short worklist saves. Every rank
    returns the full float64 matrix, equal to engine.dense_matrix's."""
    devs = _devices(devices)
    n_world, rank = world()

    t0 = time.perf_counter()
    plan = E.dense_plan(db1, db2, spec, score_int, ignore_counts, tile_m,
                        tile_n)
    t_pack = time.perf_counter() - t0

    if devices is None:
        fit = len(plan.work) // (n_world * DENSE_TILES_PER_SHARD_MIN)
        devs = devs[: max(1, fit)]
    n_local = len(devs)
    _check_shards(n_local, n_world)
    n_shards = n_world * n_local
    mine = range(rank * n_local, (rank + 1) * n_local)

    t0 = time.perf_counter()
    balance = os.environ.get("COMPAIRR_SHARD_BALANCE", "1") != "0"
    bounds = (_balanced_bounds(plan, db1.n, n_shards) if balance
              else _equal_span_bounds(db1.n, n_shards))
    rows = _span_rows(bounds, tile_m)
    lists = [
        E.order_colmajor(E.worklist_from_keys(
            plan.key_a[lo:hi], hi - lo, plan.key_b, db2.n,
            int(plan.indels), tile_m, tile_n,
        ))
        for lo, hi in bounds
    ]
    real = [len(t) for t in lists]
    longest = max(real, default=0)
    LAST_STATS.clear()
    LAST_STATS.update(
        devices=n_shards,
        backend=_backend_name(),
        pack_s=t_pack,
        shard_s=time.perf_counter() - t0,
        real_tiles=real,
        padded_tiles_per_shard=longest,
        pad_fraction=1.0 - sum(real) / max(n_shards * longest, 1),
    )

    t0 = time.perf_counter()
    a0 = E.dense_side(plan, db1, plan.order_a, plan.key_a, plan.npad_a,
                      devs[0])
    b0 = a0 if plan.shared else E.dense_side(plan, db2, plan.order_b,
                                             plan.key_b, plan.npad_b,
                                             devs[0])
    b_sides = [E.DenseSide(rows_b, b0.key, b0.n)
               for rows_b, in E.replicate((b0.rows,), devs)]
    a_sides = [E.side_span(a0, lo, hi, rows, d)
               for d, (lo, hi) in zip(devs, bounds[mine.start : mine.stop])]
    del a0, b0
    _sync(devs)
    LAST_STATS["put_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sums = _Sums(plan)
    for g, a, b in zip(mine, a_sides, b_sides):
        if len(lists[g]):
            sums.add(E.dense_span(plan, a, b, lists[g]))
    total = sums.total(devs[0])
    _sync(devs)
    LAST_STATS["compute_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if n_world > 1:
        total = _all_reduce(total)
    LAST_STATS["allreduce_s"] = time.perf_counter() - t0
    return E.dense_result(plan, total)


def _to(side: dict, dev) -> dict:
    return {k: t.to(dev) for k, t in side.items()}


def _handoff(sides: list, devs: list, n_world: int, rank: int) -> list:
    """One step of the ring (JAX's ppermute with perm [(i, (i - 1) % n)]):
    shard k takes shard k + 1's set-2 rows, from the next local device,
    or for a rank's last shard from the next rank's first, by
    batch_isend_irecv of every tensor of the rows (through the host under
    gloo, which sends CPU tensors only). Every set-2 shard has the same
    shapes, so a receiver sizes its buffers from the rows it sends."""
    moved = [_to(sides[i + 1], devs[i]) for i in range(len(devs) - 1)]
    if n_world == 1:
        return moved + [_to(sides[0], devs[-1])]
    names = sorted(sides[0])
    gloo = dist.get_backend() == "gloo"
    send = [sides[0][k].cpu() if gloo else sides[0][k] for k in names]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, (rank - 1) % n_world) for t in send]
    ops += [dist.P2POp(dist.irecv, t, (rank + 1) % n_world) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return moved + [{k: t.to(devs[-1]) for k, t in zip(names, recv)}]


def dense_matrix_ring(
    db1: SeqDB,
    db2: SeqDB,
    spec: MatchSpec,
    score_int: int,
    ignore_counts: bool,
    devices: Optional[Sequence] = None,
    tile_m: int = TILE_M,
    tile_n: int = TILE_N,
) -> np.ndarray:
    """[R1, R2] overlap matrix with both sets cut into equal row spans
    over the global shards: each shard keeps its set-1 span while the
    set-2 spans pass round the ring, shard k holding set-2 span
    (k + s) % n at step s, so no device holds more than one set-2 span.
    Every rank returns the full float64 matrix, equal to
    engine.dense_matrix's."""
    devs = _devices(devices)
    n_world, rank = world()
    n_local = len(devs)
    _check_shards(n_local, n_world)
    n = n_world * n_local
    mine = range(rank * n_local, (rank + 1) * n_local)

    plan = E.dense_plan(db1, db2, spec, score_int, ignore_counts, tile_m,
                        tile_n)
    a_bounds = _equal_span_bounds(db1.n, n)
    b_bounds = _equal_span_bounds(db2.n, n)
    a_rows = _span_rows(a_bounds, tile_m)
    a0 = E.dense_side(plan, db1, plan.order_a, plan.key_a, plan.npad_a,
                      devs[0])
    a_sides = [E.side_span(a0, lo, hi, a_rows, d)
               for d, (lo, hi) in zip(devs, a_bounds[mine.start : mine.stop])]
    if plan.shared:  # the same spans, rows and layout: share them
        b_cur = [a.rows for a in a_sides]
    else:
        b0 = E.dense_side(plan, db2, plan.order_b, plan.key_b, plan.npad_b,
                          devs[0])
        b_rows = _span_rows(b_bounds, tile_n)
        b_cur = [E.side_span(b0, lo, hi, b_rows, d).rows
                 for d, (lo, hi) in zip(devs,
                                        b_bounds[mine.start : mine.stop])]
        del b0
    del a0

    t0 = time.perf_counter()
    handoff_s = 0.0
    sums = _Sums(plan)
    for s in range(n):
        for i, g in enumerate(mine):
            lo, hi = b_bounds[(g + s) % n]
            if a_sides[i].n and hi > lo:
                b = E.DenseSide(b_cur[i], plan.key_b[lo:hi], hi - lo)
                sums.add(E.dense_span(plan, a_sides[i], b))
        if s < n - 1:
            th = time.perf_counter()
            b_cur = _handoff(b_cur, devs, n_world, rank)
            handoff_s += time.perf_counter() - th
    total = sums.total(devs[0])
    _sync(devs)
    LAST_STATS.clear()
    LAST_STATS.update(devices=n, backend=_backend_name(),
                      compute_s=time.perf_counter() - t0,
                      handoff_s=handoff_s)

    t0 = time.perf_counter()
    if n_world > 1:
        total = _all_reduce(total)
    LAST_STATS["allreduce_s"] = time.perf_counter() - t0
    return E.dense_result(plan, total)
