"""The port's bench (compairr_tpu_torch/bench.py) against the JAX package's
bench.py on the CPU: the generator gives the same arrays (the same numpy
RNG calls), the headline gives JAX's matched pairs and checksum on every
route of the port (host, tile route, dense engine), the kernel section's
checksum equals JAX's dense_matrix on the same sets, and main() raises
with no card unless the CPU is asked for. Exact: no tolerance."""

import json
import tempfile

import numpy as np
import pytest

import bench as jbench
from compairr_tpu_torch import bench as tbench

ARRS = ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no")


@pytest.fixture
def own_tmp(monkeypatch, tmp_path):
    """The port's dataset cache under tmp_path (tempfile.gettempdir())."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _assert_same_db(t, j, residues=True):
    for k in ARRS:
        np.testing.assert_array_equal(np.asarray(getattr(t, k)),
                                      getattr(j, k))
    assert t.repertoire_ids == j.repertoire_ids
    assert t.genes.v_names == j.genes.v_names
    assert t.genes.j_names == j.genes.j_names
    assert (t.n, t.longest, t.shortest) == (j.n, j.longest, j.shortest)
    if residues:
        assert t.residues_count == j.residues_count


def _jax_headline_db(n):
    """The JAX package's headline set as its _headline_db makes it on a
    cache miss (its own cache path is left alone)."""
    d = jbench.synth_arrays(n, n_reps=120, n_v=50, n_j=13, seed=1)
    jbench._plant_near_dups(d, d, 0.01, seed=7)
    return d


def test_synth_arrays_and_planting_equal_jax():
    t1 = tbench.synth_arrays(5000, 60, 48, 13, seed=11)
    t2 = tbench.synth_arrays(5000, 60, 48, 13, seed=12)
    j1 = jbench.synth_arrays(5000, 60, 48, 13, seed=11)
    j2 = jbench.synth_arrays(5000, 60, 48, 13, seed=12)
    _assert_same_db(t1, j1)
    tbench._plant_near_dups(t1, t2, 0.01, seed=13)
    jbench._plant_near_dups(j1, j2, 0.01, seed=13)
    _assert_same_db(t2, j2)
    kt1, kt2 = tbench.kernel_sets(5000)
    _assert_same_db(kt1, j1)
    _assert_same_db(kt2, j2)


def test_headline_db_equals_jax_and_its_cache(own_tmp):
    want = _jax_headline_db(8192)
    made = tbench._headline_db(8192)  # a cache miss: made and stored
    _assert_same_db(made, want)
    assert (own_tmp / "compairr_torch_bench_headline_8192_v2").is_dir()
    hit = tbench._headline_db(8192)  # a hit: memory-mapped arrays
    assert isinstance(hit.seqs, np.memmap)
    # as in the JAX package, a miss keeps the residue count of the rows
    # before planting and a hit counts the planted rows' lengths
    _assert_same_db(hit, want, residues=False)
    assert hit.residues_count == int(want.lengths.sum())


def test_headline_equals_jax_on_every_route(own_tmp, monkeypatch):
    from compairr_tpu_torch.constants import SCORE_PRODUCT
    from compairr_tpu_torch.ops import engine as E

    monkeypatch.setattr(jbench, "_headline_db", _jax_headline_db)
    _, j_sum, j_pairs = jbench._headline(8192, False)
    assert j_pairs > 8192 and j_sum > 0

    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    _, t_sum, t_pairs, m = tbench._headline(8192)
    assert (t_sum, t_pairs) == (j_sum, j_pairs)
    assert E.LAST_ROUTE == "pigeonhole"

    d = tbench._headline_db(8192)
    monkeypatch.setenv("COMPAIRR_PIGEONHOLE", "0")
    _, tile_sum, tile_pairs, tile_m = tbench._headline(8192, d)
    assert E.LAST_ROUTE == "tiles"
    assert (tile_sum, tile_pairs) == (j_sum, j_pairs)
    np.testing.assert_array_equal(tile_m, m)

    spec = E.MatchSpec(differences=2, indels=False, ignore_genes=False)
    dense = E.dense_matrix(d, d, spec, SCORE_PRODUCT, False, device="cpu")
    np.testing.assert_array_equal(dense, m)


def test_kernel_section_equals_jax_dense_matrix(monkeypatch):
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.ops.engine import MatchSpec, dense_matrix

    monkeypatch.setenv("COMPAIRR_BENCH_NK", "20000")
    monkeypatch.setenv("COMPAIRR_BENCH_KERNEL_REPS", "1")
    km = tbench._kernel_metrics(768, "cpu")
    j1 = jbench.synth_arrays(20000, n_reps=60, n_v=48, n_j=13, seed=11)
    j2 = jbench.synth_arrays(20000, n_reps=60, n_v=48, n_j=13, seed=12)
    jbench._plant_near_dups(j1, j2, 0.01, seed=13)
    want = dense_matrix(j1, j2, MatchSpec(2, False, False), SCORE_PRODUCT,
                        False)
    assert want.sum() > 0
    assert km["kernel_checksum"] == float(want.sum())
    assert km["kernel_bound_s"] is None and km["device_kind"] == "cpu"
    assert len(km["kernel_rep_walls_s"]) == 3
    assert km["kernel_wall_s"] == min(km["kernel_rep_walls_s"])
    assert 0 < km["kernel_visited_fraction"] <= 1


def test_dense_bound_counts_and_refuses_unknown_cards():
    """The bound of a small plan by hand: bytes of the rows the tiles
    cover, the worklist and the matrix; operations 2 a residue of every
    equal-key pair, the pair's length counted row by row. A card without
    published peaks raises."""
    import torch

    d1, d2 = tbench.kernel_sets(3000)
    run, plan, a, b = tbench.prepared_dense(d1, d2, 128,
                                            torch.device("cpu"))
    card = "NVIDIA H100 80GB HBM3"
    ops, bw = tbench.PEAKS[card]
    la, lb = d1.lengths[plan.order_a], d2.lengths[plan.order_b]
    same = a.key[: a.n, None] == b.key[None, : b.n]
    assert (la[:, None] == lb[None, :])[same].all()
    residues = int((same * la[:, None].astype(np.int64)).sum())
    assert tbench.key_pairs(a.key[: a.n], b.key[: b.n]) == (int(same.sum()),
                                                             residues)
    assert residues < plan.lpad * int(same.sum())
    covered = [tbench.touched_rows(plan.work[:, c], 128,
                                    side.rows["rep"].shape[0])
               for c, side in ((0, a), (1, b))]
    n_bytes = (plan.work.nbytes + plan.r1p * plan.r2p * 8
               + (plan.lpad + 12) * sum(covered))
    bd = tbench.dense_bound(plan, a, b, card)
    assert bd["equal_key_pairs"] == int(same.sum())
    assert bd["bytes"] == n_bytes and bd["ops"] == 2.0 * residues
    assert bd["bound_ms"] == pytest.approx(
        max(n_bytes / bw, 2.0 * residues / ops) * 1e3, rel=1e-12)
    assert bd["bound_by"] == ("bytes" if n_bytes / bw >= 2.0 * residues / ops
                              else "operations")
    with pytest.raises(ValueError, match="no published peaks"):
        tbench.dense_bound(plan, a, b, "some other card")


@pytest.mark.parametrize("shift", [1, -1])
def test_key_pairs_one_apart_weigh_the_shorter_row(shift):
    """Keys 1 apart: the pairs with key_a + shift == key_b, each weighed
    by the shorter row's length (the key's low 16 bits), counted row by
    row."""
    rng = np.random.default_rng(5)
    vj = rng.integers(0, 3, size=(2, 400)).astype(np.int64)
    length = rng.integers(9, 13, size=(2, 400)).astype(np.int64)
    ka, kb = (vj << 16) | length
    hit = (ka[:, None] + shift) == kb[None, :]
    shorter = np.minimum(length[0][:, None], length[1][None, :])
    assert hit.any()
    assert tbench.key_pairs(ka, kb, shift) == (int(hit.sum()),
                                               int((hit * shorter).sum()))


def test_main_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "_ensure_native", lambda: None)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tbench.main()


def test_main_on_the_cpu_prints_one_json_line(own_tmp, monkeypatch, capsys):
    monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    monkeypatch.setenv("COMPAIRR_BENCH_N", "4096")
    # the native helpers are built by the bench on the card's machine;
    # here they would un-skip the parser's fixture tests
    monkeypatch.setattr(tbench, "_ensure_native", lambda: None)
    tbench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "wall_s",
                "matched_pairs", "matrix_checksum",
                "route_tiles_per_device_min"):
        assert key in out, key
    assert out["device_kind"] == "cpu" and out["power_limit_w"] is None
    assert out["route"] == "pigeonhole"  # the default route at -d 2
    assert "kernel_checksum" not in out  # the kernel section is card-only
    d = _jax_headline_db(4096)
    from compairr_tpu.constants import SCORE_PRODUCT
    from compairr_tpu.core.score import pair_scores
    from compairr_tpu.ops.engine import MatchSpec, find_pairs

    i1, i2, _ = find_pairs(d, d, MatchSpec(2, False, False))
    assert out["matched_pairs"] == len(i1)
    assert out["matrix_checksum"] == float(
        pair_scores(d.counts[i1], d.counts[i2], SCORE_PRODUCT, False).sum())
