"""The port's route rule (ops/engine.py card_route) on the CPU.

  * card_route as a pure function: the tile route for one-indel runs,
    the host routes for substitution runs and d=0, whatever the device
    requested; COMPAIRR_PIGEONHOLE=0 and =all override it;
  * find_pairs and prefetch_find_pairs follow the rule: LAST_ROUTE, the
    prefetch's worker, a CPU request, a tile route with no card (it
    raises), and a fresh process (the host route, torch never imported);
  * every route's pairs equal the JAX package's find_pairs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from compairr_tpu.ops import engine as jeng
from compairr_tpu_torch.ops import engine as teng

from torch_port_data import read_pair, write_pair

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODES = [None, "1", "0", "all"]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return read_pair(*write_pair(tmp_path_factory.mktemp("routing")))


def _mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    else:
        monkeypatch.setenv("COMPAIRR_PIGEONHOLE", mode)


def _sorted(res):
    i1, i2, dist = res
    o = np.lexsort((i2, i1))
    return i1[o], i2[o], (None if dist is None else dist[o])


def _assert_same_pairs(got, want):
    g, w = _sorted(got), _sorted(want)
    for a, b in zip(g, w):
        if b is not None:
            np.testing.assert_array_equal(a, b)


# ---- card_route, a pure function ------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("indels", [False, True])
@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_card_route(d, indels, mode, monkeypatch):
    """d=0 never leaves the exact hash join; otherwise =0 sends every
    run to the tile route and =all none, and unset or 1 sends exactly
    the one-indel runs. -g, -f, a self-comparison and the device
    requested (COMPAIRR_DEVICE) change nothing."""
    _mode(monkeypatch, mode)
    if d == 0:
        want = False
    else:
        want = {"0": True, "all": False}.get(mode, indels and d == 1)
    for device in (None, "cpu", "cuda"):
        if device is None:
            monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
        else:
            monkeypatch.setenv("COMPAIRR_DEVICE", device)
        assert teng.card_route(teng.MatchSpec(d, indels, False)) is want
        spec = teng.MatchSpec(d, indels, True, exclude_self=True)
        assert teng.card_route(spec) is want


# ---- find_pairs and the prefetch follow the rule ---------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "d,indels", [(0, False), (1, False), (1, True), (2, False), (3, False)]
)
def test_find_pairs_route_follows_the_rule(dbs, d, indels, mode,
                                           monkeypatch):
    """On the CPU LAST_ROUTE is the tile route exactly where card_route
    says so, and each route gives the JAX package's pairs."""
    (j1, j2), (t1, t2) = dbs
    _mode(monkeypatch, mode)
    spec = teng.MatchSpec(d, indels, False)
    card = teng.card_route(spec)
    got = teng.find_pairs(t1, t2, spec, device="cpu")
    assert (teng.LAST_ROUTE == "tiles") is card
    if d == 0:
        assert teng.LAST_ROUTE == "exact"
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")  # JAX's host routes
    want = jeng.find_pairs(j1, j2, jeng.MatchSpec(d, indels, False))
    _assert_same_pairs(got, want)


@pytest.mark.parametrize("d,indels", [(1, False), (1, True), (2, False)])
def test_cpu_request_keeps_the_route(dbs, d, indels, monkeypatch):
    """A CPU request (device= or COMPAIRR_DEVICE=cpu) changes no route:
    substitution runs take the host pigeonhole and prefetch nothing,
    one-indel runs the tile route on the kernels' plain versions."""
    (_, _), (t1, t2) = dbs
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    want = "tiles" if indels else "pigeonhole"
    spec = teng.MatchSpec(d, indels, False)
    teng.find_pairs(t1, t2, spec, device="cpu")
    assert teng.LAST_ROUTE == want
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    teng.prefetch_find_pairs(t1, t2, spec)
    assert bool(teng._RESULT_PREFETCH) is indels
    teng.find_pairs(t1, t2, spec, want_dist=False)  # joins the prefetch
    assert teng.LAST_ROUTE == want and not teng._RESULT_PREFETCH


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize(
    "d,indels", [(1, False), (1, True), (2, False), (3, False)]
)
def test_prefetch_starts_exactly_for_the_card_route(dbs, d, indels, card,
                                                    monkeypatch):
    """prefetch_find_pairs starts its worker exactly when card_route
    (here made to answer `card`) names the tile route, and the next
    find_pairs joins it for the same pairs."""
    (_, _), (t1, t2) = dbs
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.delenv("COMPAIRR_PIGEONHOLE", raising=False)
    asked = []

    def rule(spec):
        asked.append(spec)
        return card

    monkeypatch.setattr(teng, "card_route", rule)
    spec = teng.MatchSpec(d, indels, False)
    teng.prefetch_find_pairs(t1, t2, spec, want_dist=True)
    # asked by the prefetch (and, on a worker, by its own find_pairs)
    assert asked and asked[0] == spec
    assert bool(teng._RESULT_PREFETCH) is card
    got = teng.find_pairs(t1, t2, spec)
    assert not teng._RESULT_PREFETCH
    assert teng.LAST_ROUTE == ("tiles" if card else
                               "pigeonhole_indel" if indels else "pigeonhole")
    monkeypatch.undo()
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "all")
    _assert_same_pairs(got, teng.find_pairs(t1, t2, spec, device="cpu"))


@pytest.mark.parametrize(
    "mode,d,indels,raises",
    [
        (None, 1, True, True),
        ("0", 2, False, True),
        ("0", 1, True, True),
        (None, 2, False, False),
        ("1", 1, False, False),
        ("all", 1, True, False),
    ],
)
def test_no_card_on_the_tile_route_raises(dbs, mode, d, indels, raises,
                                          monkeypatch):
    """With no card and no CPU request, a run that the rule sends to the
    tile route raises resolve_device's error, in find_pairs and in the
    prefetch: nothing falls back to the host or the CPU. A run that the
    rule keeps on the host runs there."""
    import torch

    (_, _), (t1, t2) = dbs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    _mode(monkeypatch, mode)
    spec = teng.MatchSpec(d, indels, False)
    if raises:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            teng.find_pairs(t1, t2, spec)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            teng.prefetch_find_pairs(t1, t2, spec)
    else:
        teng.prefetch_find_pairs(t1, t2, spec)
        i1, _, _ = teng.find_pairs(t1, t2, spec)
        assert teng.LAST_ROUTE.startswith("pigeonhole") and len(i1)
    assert not teng._RESULT_PREFETCH


def test_fresh_process_keeps_the_host_route_without_torch(tmp_path):
    """A fresh process with no COMPAIRR_DEVICE runs a -d 2 substitution
    run of 100,000 rows a set on the host without loading torch, the
    prefetch and the CLI included."""
    code = (
        "import sys\n"
        "from compairr_tpu_torch.bench import kernel_sets\n"
        "from compairr_tpu_torch.ops import engine as E\n"
        "a, b = kernel_sets(100_000)\n"
        "spec = E.MatchSpec(2, False, False)\n"
        "E.prefetch_find_pairs(a, b, spec)\n"
        "i1, _, _ = E.find_pairs(a, b, spec)\n"
        "assert E.LAST_ROUTE == 'pigeonhole' and len(i1)\n"
        "from compairr_tpu_torch import cli\n"
        f"a_tsv, b_tsv = {write_pair(tmp_path)!r}\n"
        "assert cli.main(['-m', '-d', '2', a_tsv, b_tsv, '-o', "
        f"{str(tmp_path / 'out.tsv')!r}]) == 0\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("COMPAIRR_DEVICE", "COMPAIRR_PIGEONHOLE")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
