"""The card route of read_db (io/card.py) on the CPU: the parse kernel's
plain version (ops/kernels.py airr_scan_plain and friends) held to the
port's pure-Python parser and, where native/libairr_parser.so is built,
to the native parser, rows ignored under -u and -e included; the
fallback of every error kind to the host parser's message; token keys
shared in one try told apart by the next; the rule that takes the
route, and the import that lets a fresh CLI process take it."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from compairr_tpu_torch.config import Options
from compairr_tpu_torch.core.db import GeneTables
from compairr_tpu_torch.io import airr, card
from compairr_tpu_torch.io.native import load_library
from compairr_tpu_torch.ops import kernels as K
from compairr_tpu_torch.utils import trace
from compairr_tpu_torch.utils.progress import Logger

CPU = torch.device("cpu")
H = "repertoire_id\tsequence_id\tduplicate_count\tv_call\tj_call\tjunction_aa"
ROWS = ["A\tS1\t3\tTRBV1\tTRBJ1\tCASSLG", "B\tS2\t7\tTRBV2\tTRBJ1\tCASRW",
        "A\tS3\t1\tTRBV1\tTRBJ2\tCASSLG", "C\tS4\t12\tTRBV3\tTRBJ1\tCAW"]


def _tsv(header, rows, end="\n", final=True):
    return end.join([header, *rows]) + (end if final else "")


# name: (file texts, Options keywords, require_sequence_id, default id)
CASES = {
    "comments": (["#made by a tool\n@another\n" + _tsv(H, ROWS)], {},
                 False, "1"),
    "column_order": ([_tsv("junction_aa\tj_call\tduplicate_count\tv_call"
                           "\trepertoire_id\tsequence_id",
                           ["CASS\tJ1\t2\tV1\tR1\tS1", "CAT\tJ2\t5\tV1\tR2\tS2",
                            "CASS\tJ1\t9\tV2\tR1\tS3"])], {}, False, "1"),
    "extra_columns": ([_tsv("x\t" + H + "\ty\tjunction_aa",
                            ["q\t" + r + "\tz\tCAWW" for r in ROWS])], {},
                      False, "1"),
    "missing_trailing": ([_tsv("junction_aa\tduplicate_count\tv_call\tj_call"
                               "\tsequence_id\trepertoire_id",
                               ["CASS\t2\tV1\tJ1", "CAT\t3\tV2\tJ1\tS2",
                                "CAW\t4\tV1\tJ2\tS3\tR7", "CASS\t1\tV1\tJ1"])],
                         {}, False, "dflt"),
    "crlf": ([_tsv(H, ROWS, end="\r\n")], {}, False, "1"),
    "no_final_newline": ([_tsv(H, ROWS, final=False)], {}, False, "1"),
    "no_final_newline_crlf": ([_tsv(H, ROWS, end="\r\n", final=False)], {},
                              False, "1"),
    "sequence_id_present": ([_tsv(H, ROWS)], {}, True, "1"),
    "sequence_id_absent": ([_tsv(
        "repertoire_id\tduplicate_count\tv_call\tj_call\tjunction_aa",
        [re.sub(r"\tS\d", "", r) for r in ROWS])], {}, False, "1"),
    "sequence_id_empty": ([_tsv(H, ["A\t\t3\tV1\tJ1\tCASS",
                                    "A\tS2\t1\tV1\tJ1\tCAT",
                                    "B\t\t2\tV2\tJ1\tCAW"])], {}, False, "1"),
    "nucleotides": ([_tsv("repertoire_id\tduplicate_count\tv_call\tj_call"
                          "\tjunction", ["A\t1\tV1\tJ1\tacgtu",
                                         "A\t2\tV1\tJ2\tTGCA",
                                         "B\t3\tV2\tJ1\tgattaca"])],
                    {"nucleotides": True}, False, "1"),
    "cdr3": ([_tsv(H + "\tcdr3_aa", [r + "\tASS" + "LGW"[i % 3]
                                    for i, r in enumerate(ROWS)])],
             {"cdr3": True}, False, "1"),
    "cdr3_nucleotides": ([_tsv("repertoire_id\tduplicate_count\tv_call"
                               "\tj_call\tcdr3\tjunction",
                               ["A\t1\tV1\tJ1\tacg\tx", "A\t2\tV1\tJ1\tttt\ty"])],
                         {"cdr3": True, "nucleotides": True}, False, "1"),
    "lowercase": ([_tsv(H, [r[:-6] + r[-6:].lower() for r in ROWS])], {},
                  False, "1"),
    "count_space_plus": ([_tsv(H, ["A\tS1\t +3\tV1\tJ1\tCASS",
                                   "A\tS2\t  7\tV1\tJ1\tCAT",
                                   "A\tS3\t+007\tV2\tJ1\tCAW"])], {},
                         False, "1"),
    "default_repertoire": ([_tsv("sequence_id\tduplicate_count\tv_call"
                                 "\tj_call\tjunction_aa",
                                 [r[2:] for r in ROWS])], {}, False, "2"),
    "ignore_genes_counts": ([_tsv("repertoire_id\tjunction_aa\tv_call",
                                  ["A\tCASS\tV1", "A\tCAT", "B\tCAW\t"])],
                            {"ignore_genes": True, "ignore_counts": True},
                            False, "1"),
    "count_guard": ([_tsv(H, ["A\tS1\t4611686018427387904\tV1\tJ1\tCASS",
                              "A\tS2\t1\tV1\tJ1\tCAT"])], {}, False, "1"),
    "ignore_unknown": ([_tsv(H, ["A\tS1\t3\tV1\tJ1\tCA5S",
                                 "A\tS2\t7\tV2\tJ1\tCASS",
                                 "B\tS3\t1\tV3\tJ2\tC55S5",
                                 "B\tS4\t2\tV2\tJ2\tCAW"])],
                       {"ignore_unknown": True}, False, "1"),
    "ignore_empty": ([_tsv(H, ["A\tS1\t3\tV1\tJ1\t", "A\tS2\t7\tV2\tJ1\tCASS",
                               "", "B\tS3\t1\tV3", "B\tS4\t2\tV2\tJ2\tCAW"])],
                     {"ignore_empty": True}, False, "1"),
    "ignore_both": ([_tsv(H, ["A\tS1\t3\tV1\tJ1\t555", "Z\tS2\t7\tV9\tJ9\tCA5",
                              "A\tS3\t2\tV2\tJ1\tCASS", "A\tS4\t1\tV1\tJ1\t",
                              "B\tS5\t4\tV1\tJ2\tCAW"], end="\r\n")],
                    {"ignore_unknown": True, "ignore_empty": True}, False,
                    "1"),
    "ignored_rows_unchecked": ([_tsv(H, ["A\t\t0\t\t\tCA5S",
                                         "A\tS2\t7\tV2\tJ1\tCASS",
                                         "B\t\tx\tV1\t\t",
                                         "B\tS4\t2\tV2\tJ2\tCAW"])],
                               {"ignore_unknown": True, "ignore_empty": True},
                               True, "1"),
    "ignore_nucleotides": ([_tsv("repertoire_id\tduplicate_count\tv_call"
                                 "\tj_call\tjunction",
                                 ["A\t1\tV1\tJ1\tacgnt", "A\t2\tV1\tJ2\tTGCA",
                                  "B\t3\tV2\tJ1\tNN"])],
                           {"nucleotides": True, "ignore_unknown": True,
                            "ignore_empty": True}, False, "1"),
    "all_ignored": ([_tsv(H, ["A\tS1\t3\tV1\tJ1\tCA5S", "A\tS2\t1\tV1\tJ1\t"])],
                    {"ignore_unknown": True, "ignore_empty": True}, False,
                    "1"),
    "shared_genes": ([_tsv(H, ["A\tS1\t1\tV5\tJ2\tCASS",
                               "A\tS2\t1\tV1\tJ2\tCAT",
                               "A\tS3\t1\tV5\tJ1\tCAW"]),
                      _tsv(H, ["B\tS1\t1\tV1\tJ3\tCASS",
                               "B\tS2\t1\tV9\tJ1\tCAT",
                               "B\tS3\t1\tV5\tJ4\tCAW",
                               "B\tS4\t1\tV0\tJ2\tCAW"])], {}, False, "1"),
}


def _write(tmp_path, texts):
    paths = []
    for k, text in enumerate(texts):
        p = tmp_path / f"in{k}.tsv"
        p.write_bytes(text.encode("latin-1"))
        paths.append(str(p))
    return paths


def _read(paths, opt, require_sid, default, how, monkeypatch):
    """SeqDBs of the files (one GeneTables) and the log's text, timings
    blanked: how is "plain" (the card route on the CPU), "python" or
    "native" (the host parsers)."""
    genes, out = GeneTables(), io.StringIO()
    log = Logger(out, to_file=True)
    dbs = []
    for path in paths:
        if how == "plain":
            db, why = card.read_db_card(path, opt, genes, log, require_sid,
                                        default, CPU)
            assert why is None, why
        else:
            with monkeypatch.context() as m:
                m.setenv("COMPAIRR_NATIVE_IO",
                         "1" if how == "native" else "0")
                db = airr.read_db(path, opt, genes, log, require_sid,
                                  default)
        dbs.append(db)
    return dbs, re.sub(r"\(\d+\.\d+s\)", "(t)", out.getvalue())


def _fnv(db):
    out = np.empty(db.n, dtype=np.uint64)
    for i in range(db.n):
        h = 1469598103934665603
        for c in db.seqs[i, :db.lengths[i]]:
            h = ((h ^ int(c)) * 1099511628211) & (2**64 - 1)
        out[i] = h
    return out


@pytest.mark.parametrize("how", ["python", "native"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_parse_equals_host(tmp_path, monkeypatch, case, how):
    if how == "native" and load_library() is None:
        pytest.skip("native parser not built")
    texts, kw, require_sid, default = CASES[case]
    paths = _write(tmp_path, texts)
    opt = Options(**kw)
    got, got_log = _read(paths, opt, require_sid, default, "plain",
                         monkeypatch)
    want, want_log = _read(paths, opt, require_sid, default, how,
                           monkeypatch)
    assert got_log == want_log
    assert got[0].genes.v_names == want[0].genes.v_names
    assert got[0].genes.j_names == want[0].genes.j_names
    for a, b in zip(got, want):
        for k in ("seqs", "lengths", "counts", "rep_no", "v_no", "j_no"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        for k in ("repertoire_ids", "ignored_unknown", "ignored_empty",
                  "residues_count", "total_dup_count", "shortest",
                  "longest"):
            assert getattr(a, k) == getattr(b, k), k
        assert list(a.sequence_ids) == list(b.sequence_ids)
        assert a.keep == b.keep
        assert a.row_hash.dtype == np.uint64
        # the pure-Python parser leaves the row hash to its first reader
        if b.row_hash is not None:
            assert np.array_equal(a.row_hash, b.row_hash)
        assert np.array_equal(a.row_hash, _fnv(b))
        if how == "native":
            assert b.row_hash is not None
            for k in ("_blob", "_off", "_has"):
                x = np.asarray(getattr(a.sequence_ids, k))
                y = np.asarray(getattr(b.sequence_ids, k))
                assert x.dtype == y.dtype and np.array_equal(x, y), k


BAD = {  # row (after H): the host parser's message, or its ignored counts
    # (the two ignore kinds, which stay on the card route)
    "illegal_char": ("A\tS1\t1\tV1\tJ1\tCA5S", {}, False),
    "nonprint_char": ("A\tS1\t1\tV1\tJ1\tCA\x01S", {}, False),
    "high_byte": ("A\tS1\t1\tV1\tJ1\tCA\xe9S", {}, False),
    "empty_sequence": ("A\tS1\t1\tV1\tJ1\t", {}, False),
    "missing_sequence": ("A\tS1\t1\tV1\tJ1", {}, False),
    "missing_sequence_id": ("A\t\t1\tV1\tJ1\tCASS", {}, True),
    "bad_count": ("A\tS1\t0\tV1\tJ1\tCASS", {}, False),
    "negative_count": ("A\tS1\t-4\tV1\tJ1\tCASS", {}, False),
    "count_past_guard": ("A\tS1\t4611686018427387905\tV1\tJ1\tCASS", {},
                         False),
    "missing_count": ("A\tS1\t\tV1\tJ1\tCASS", {}, False),
    "missing_v": ("A\tS1\t1\t\tJ1\tCASS", {}, False),
    "missing_j": ("A\tS1\t1\tV1\t\tCASS", {}, False),
    "empty_line": ("", {}, False),
    "ignore_unknown": ("A\tS1\t1\tV1\tJ1\tCA5S", {"ignore_unknown": True},
                       False),
    "ignore_empty": ("A\tS1\t1\tV1\tJ1\t", {"ignore_empty": True}, False),
    "missing_columns": (None, {}, True),
}


def _host_or_routed(path, opt, require_sid, route, monkeypatch):
    """(SeqDB or exit code, log text, io.parse counts) of read_db with the
    card route taken on the CPU (route) or the host parser alone."""
    monkeypatch.setattr(card, "card_device",
                        (lambda *a: CPU) if route else (lambda *a: None))
    monkeypatch.setenv("COMPAIRR_NATIVE_IO", "1")
    monkeypatch.setenv("COMPAIRR_TIMING", "1")
    trace.refresh()
    trace.reset()
    out = io.StringIO()
    try:
        try:
            res = airr.read_db(path, opt, GeneTables(), Logger(out, True),
                               require_sid, "1")
        except SystemExit as e:
            res = e.code
        (sp,) = [s for s in trace.spans() if s.name == "io.parse"]
    finally:
        trace.reset()
        monkeypatch.delenv("COMPAIRR_TIMING")
        trace.refresh()
    return res, re.sub(r"\(\d+\.\d+s\)", "(t)", out.getvalue()), sp.counts


IGNORED = ("ignore_unknown", "ignore_empty")


@pytest.mark.parametrize("case", sorted(BAD))
def test_flagged_rows_fall_back_to_the_host(tmp_path, monkeypatch, case):
    """A row that is an error sends its file to the host parser, which
    ends the job with its message; a row ignored under -u or -e keeps
    the file on the card route, with the host parser's result, counts
    and log."""
    row, kw, require_sid = BAD[case]
    header = H if row is not None else "repertoire_id\tjunction_aa"
    rows = ROWS[:2] + [row if row is not None else "A\tCASS"] + ROWS[2:]
    path = tmp_path / "bad.tsv"
    path.write_bytes(_tsv(header, rows).encode("latin-1"))
    opt = Options(**kw)
    got, got_log, counts = _host_or_routed(str(path), opt, require_sid, True,
                                           monkeypatch)
    want, want_log, _ = _host_or_routed(str(path), opt, require_sid, False,
                                        monkeypatch)
    assert got_log == want_log
    if case in IGNORED:
        assert (counts["route"], counts["fallback"]) == ("card", "none")
    else:
        assert counts["route"] == "host"
        assert counts["fallback"] == ("header" if row is None
                                      else "flagged_row")
    if isinstance(want, int):
        assert got == want == 1
        assert "Error" in want_log or "Missing essential" in want_log
    else:
        assert (got.n, got.ignored_unknown, got.ignored_empty) == (
            want.n, want.ignored_unknown, want.ignored_empty)
        assert np.array_equal(got.seqs, want.seqs)


def test_clean_file_stays_on_the_card_route(tmp_path, monkeypatch):
    path = tmp_path / "ok.tsv"
    path.write_text(_tsv(H, ROWS))
    got, log, counts = _host_or_routed(str(path), Options(), False, True,
                                       monkeypatch)
    assert (counts["route"], counts["fallback"]) == ("card", "none")
    assert got.n == len(ROWS) and "Sequences:         4" in log


def test_hash_collision_rekeyed_on_the_card(tmp_path, monkeypatch):
    """With the first try's tables keyed by no bit of the hash, every
    token of a kind shares one slot: the byte comparison finds the
    collision and the second try's keys tell the tokens apart, on the
    card route, with the host's result."""
    path = tmp_path / "c.tsv"
    path.write_text(_tsv(H, ROWS))
    monkeypatch.setattr(K, "AIRR_KEY_MASKS", (0, -1))
    got, _, counts = _host_or_routed(str(path), Options(), False, True,
                                     monkeypatch)
    assert (counts["route"], counts["fallback"]) == ("card", "none")
    want, _, _ = _host_or_routed(str(path), Options(), False, False,
                                 monkeypatch)
    assert got.genes.v_names == want.genes.v_names == [
        "TRBV1", "TRBV2", "TRBV3"]
    assert got.repertoire_ids == want.repertoire_ids
    for k in ("rep_no", "v_no", "j_no"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_hash_collision_falls_back(tmp_path, monkeypatch):
    """With every try's tables keyed by no bit of the hash, the
    collision outlasts the tries and the file goes to the host parser,
    with the host's result."""
    path = tmp_path / "c.tsv"
    path.write_text(_tsv(H, ROWS))
    monkeypatch.setattr(K, "AIRR_KEY_MASKS", (0, 0, 0))
    db, why = card.read_db_card(str(path), Options(), GeneTables(),
                                Logger(io.StringIO(), True), False, "1", CPU)
    assert (db, why) == (None, "collision")
    got, _, counts = _host_or_routed(str(path), Options(), False, True,
                                     monkeypatch)
    assert counts["fallback"] == "collision"
    assert got.genes.v_names == ["TRBV1", "TRBV2", "TRBV3"]


@pytest.fixture
def card_present(monkeypatch):
    """torch as if a started card were present (nothing runs on it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("COMPAIRR_DEVICE", raising=False)
    monkeypatch.delenv("COMPAIRR_NATIVE_IO", raising=False)


@pytest.mark.parametrize("case", ["taken", "no_cuda", "device_cpu", "shard",
                                  "keep_columns", "below_crossover",
                                  "cold_below_crossover", "cold_taken",
                                  "native_io_0", "stdin", "unreadable"])
def test_card_route_rule(tmp_path, monkeypatch, card_present, case):
    path = tmp_path / "big.tsv"
    path.write_bytes(b"x" * card.CARD_PARSE_MIN_BYTES)
    opt, shard, name = Options(), None, str(path)
    if case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    elif case == "device_cpu":
        monkeypatch.setenv("COMPAIRR_DEVICE", "cpu")
    elif case == "shard":
        shard = (1, 2)
    elif case == "keep_columns":
        opt = Options(keep_columns="x", keep_columns_names=("x",))
    elif case == "below_crossover":
        path.write_bytes(b"x" * (card.CARD_PARSE_MIN_BYTES - 1))
    elif case == "cold_below_crossover":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        path.write_bytes(b"x" * (card.CARD_PARSE_MIN_BYTES_COLD - 1))
    elif case == "cold_taken":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        path.write_bytes(b"x" * card.CARD_PARSE_MIN_BYTES_COLD)
    elif case == "native_io_0":
        monkeypatch.setenv("COMPAIRR_NATIVE_IO", "0")
    elif case == "stdin":
        name = "-"
    elif case == "unreadable":
        monkeypatch.setattr(card.os, "access", lambda *a: False)
    got = card.card_device(name, opt, shard)
    if case in ("taken", "cold_taken"):
        assert got == torch.device("cuda", 0)
        assert card.card_device(name, opt, (0, 1)) == got
    else:
        assert got is None


@pytest.mark.parametrize("flags,imported", [(["-d", "1", "-i"], True),
                                            (["-d", "1"], False)],
                         ids=["tile_route", "host_route"])
def test_fresh_job_on_the_card_imports_torch_before_its_parse(
        tmp_path, flags, imported):
    """A fresh CLI process whose match takes the tile route has torch
    imported when its parse asks card_device (so a file past the
    crossover may take the card route); one on a host route has not."""
    a = tmp_path / "a.tsv"
    a.write_text(_tsv(H, ROWS))
    code = (
        "import sys\n"
        "from compairr_tpu_torch import cli\n"
        "from compairr_tpu_torch.io import card\n"
        "seen = []\n"
        "rule = card.card_device\n"
        "def spy(*a):\n"
        "    seen.append('torch' in sys.modules)\n"
        "    return rule(*a)\n"
        "card.card_device = spy\n"
        f"rc = cli.main(['-m', *{flags!r}, {str(a)!r}, '-o', "
        f"{str(tmp_path / 'o.tsv')!r}])\n"
        "print('seen', rc, seen)\n"
    )
    env = dict(os.environ, COMPAIRR_DEVICE="cpu")
    env.pop("COMPAIRR_PIGEONHOLE", None)
    env.pop("COMPAIRR_ENGINE", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"seen 0 [{imported}]" in proc.stdout, proc.stdout
