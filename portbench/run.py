"""The port's benchmark: one cell of BENCHMARK.json, run on one card.

    python3 -m portbench.run --workload keck20.m-d1i --seed 12345 \\
        --seconds 30 --trace 0

A cell is a configuration (portbench/configs/<config>.json: the sets'
generator parameters) under a traffic mix (portbench/traffic/
<traffic>.json: the command-line flags, the input sets, the reference,
any environment, and the kernels that each job has to launch on the
card). Each metric of BENCHMARK.json is read from the
run's record by portbench/metrics/<name>.py. The harness finds all of
them by name, so a cell, a configuration or a metric is added by adding
files and manifest entries.

Set-up (setup_s): import torch and the port, start the card, build the
native parser if it is absent, make the cell's inputs from --seed and
write them as AIRR TSVs into a directory under TMPDIR, and run one
warm-up job (which builds and loads the kernels it needs). The window
is a closed loop with one client: jobs back to back, each one call of
compairr_tpu_torch.cli.main(argv) in this process on those files,
writing its output into the same directory, until --seconds have
passed; a job started inside the window runs to its end. Then every
job's output is compared with the reference's result worked out again
from the TSVs (portbench/reference/), every job's launches are held to
the traffic's card kernels (the program's own counts), and one JSON line
is printed.

--trace 1 runs the window under torch.profiler with the program's phase
timer on, and reports the per-layer metrics with the device's busy time.
A run with no card, or fewer cards than the cell asks for, exits 2 and
prints no result; so does a run in which a metric that the cell lists
reads nothing (exit 5).

The load comes from this one process with few threads (its native
thread pools at one thread); the garbage of set-up is frozen, and each
job's collected between jobs, outside the job's wall (inside the
window).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

from . import check, gen  # noqa: E402
from . import trace as tr  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "compairr_tpu")
CHECKS_KEY = "checks"


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _data(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, "portbench", kind, f"{name}.json")) as f:
        return json.load(f)


def cell(root: str, workload: str) -> dict:
    """The manifest's entry of the cell, with its configuration and
    traffic files loaded."""
    m = load_manifest(root)
    wl = next((w for w in m["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return {"workload": wl, "manifest": m,
            "config": _data(root, "configs", wl["config"]),
            "traffic": _data(root, "traffic", wl["traffic"])}


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: with trace its per-layer ones, else its
    end-to-end ones; an entry with a workloads list applies only to
    those cells."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [e for e in entries
            if "workloads" not in e or workload in e["workloads"]]


def reader(root: str, name: str):
    """read(record) of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cache_env(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path
    inside the checkout, so that only a checkout's first run builds."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def build_native(root: str) -> None:
    """Build native/libairr_parser.so if absent; raise if the port then
    cannot load it (its pure-Python parse would be timed instead)."""
    so = os.path.join(root, "native", "libairr_parser.so")
    if not os.path.exists(so):
        subprocess.run(["make", "-C", os.path.join(root, "native")],
                       check=True, stdout=subprocess.DEVNULL)
    from compairr_tpu_torch.io import native

    if native.load_library() is None:
        raise RuntimeError(f"the port cannot load {so}")


def write_inputs(config: dict, traffic: dict, seed: int,
                 workdir: str) -> list:
    """The traffic's input sets of the configuration, made from seed and
    written as TSVs into workdir. Returns their paths."""
    sets = gen.make_sets(config, seed)
    paths = []
    for name in traffic["inputs"]:
        path = os.path.join(workdir, f"{name}.tsv")
        gen.write_tsv(sets[name], config["sets"][name]["columns"], path)
        paths.append(path)
    return paths


def run_job(cli, argv: list) -> tuple:
    """One job: cli.main(argv). Returns (ok, wall seconds, error)."""
    t = time.perf_counter()
    err = None
    try:
        ok = cli.main(list(argv)) == 0
    except SystemExit as e:
        ok, err = e.code in (0, None), f"exit {e.code}"
    except Exception as e:  # a failed job is counted, and the run goes on
        ok, err = False, repr(e)
    return ok, time.perf_counter() - t, err


def judge(ref_mod, traffic: dict, paths: list, outputs: list) -> tuple:
    """The reference's result over the input files, and the numbers
    compared, each with its limit."""
    exp = ref_mod.solve_cli(traffic["argv"], paths)
    want = check.expected_cells(exp)
    off = missing = 0
    for path in outputs:
        if not os.path.exists(path):
            missing += 1
            continue
        with open(path, encoding="latin-1") as f:
            off += check.cells_off(f.read(), want)
    checks = {"cells_off": {"value": off, "limit": 0},
              "outputs_missing": {"value": missing, "limit": 0}}
    return exp, checks


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def few_threads() -> None:
    """Every native thread pool of the process at one thread; torch reads
    these when it is imported, so call this first. (The card's machine
    shows 8 CPUs at one thread a core and no topology, so pinning the
    process to one CPU of each core would pin it to all of them.)"""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def launches() -> dict:
    """The program's kernel launches so far, by kernel."""
    from compairr_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)


def jobs_off_card(per_job: list, expected: list) -> int:
    """Jobs (each a dict of its launches by kernel) that did not launch
    every kernel of expected."""
    return sum(any(not j.get(k) for k in expected) for j in per_job)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            root: str = ROOT, require_card: bool = True,
            build: bool = True, out=None, err=None) -> int:
    """Run the cell; print the result line on out (last) and the numbers
    compared on err (last). Returns the exit code."""
    out = out or sys.stdout
    err = err or sys.stderr
    c = cell(root, workload)
    wl, cfg, traffic = c["workload"], c["config"], c["traffic"]
    _cache_env(root)

    import torch

    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < wl["chips"]):
        print(f"portbench: {workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=err)
        return 2
    on_card = torch.cuda.is_available() and require_card
    if on_card:
        torch.zeros(1, device="cuda").sum().item()
    os.environ.update(traffic.get("env", {}))
    if trace:
        os.environ["COMPAIRR_TIMING"] = "1"
    else:
        os.environ.pop("COMPAIRR_TIMING", None)
    if build:
        build_native(root)
    ref_mod = importlib.import_module(
        f"portbench.reference.{traffic['reference']}")

    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        paths = write_inputs(cfg, traffic, seed, workdir)
        gc.collect()
        from compairr_tpu_torch import cli

        log = os.path.join(workdir, "job.log")

        def argv(k):
            return (list(traffic["argv"]) + paths
                    + ["-o", os.path.join(workdir, f"out{k}.tsv"),
                       "-l", log])

        starts, jobs, errors, launched = [], [], [], []

        def job(k):
            before = launches()
            starts.append(time.perf_counter())
            if not trace:
                res = run_job(cli, argv(k))
            else:
                from torch.profiler import record_function

                with record_function(tr.JOB_SPAN):
                    res = run_job(cli, argv(k))
            after = launches()
            launched.append({n: after[n] - before.get(n, 0) for n in after})
            gc.collect()
            return res

        with contextlib.ExitStack() as stack:
            # a traced run starts the phase recorder and the profiler
            # before the warm-up job, so that the profiler's own start-up
            # falls outside the window
            if trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if on_card:
                    acts.append(ProfilerActivity.CUDA)
                recorder = stack.enter_context(tr.PhaseRecorder())
                prof = stack.enter_context(profile(activities=acts))
            ok, _, why = job("warmup")
            if not ok:
                print(f"portbench: the warm-up job failed: {why}", file=err)
                return 1
            gc.freeze()
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - T_START

            w0 = time.perf_counter()
            while True:
                ok, wall, why = job(len(jobs))
                jobs.append({"start": starts[-1], "wall": wall, "ok": ok})
                if why:
                    errors.append(why)
                if time.perf_counter() - w0 >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize()
            w1 = time.perf_counter()
        rec = {"setup_s": setup_s, "jobs": jobs, "window": (w0, w1),
               "on_card": on_card}
        if trace:
            trace_path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(trace_path)
            del prof
            main = threading.get_ident()
            rec["main_phases"] = [(lb, s, e) for th, lb, s, e
                                  in recorder.laps if th == main]
            rec["device_events"] = tr.device_events(trace_path, starts)
            rec["busy"] = tr.union(
                [(s, e) for _c, _n, s, e in rec["device_events"]], w0, w1)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        rec["window_peak_bytes"] = peak
        card = torch.cuda.get_device_name(0) if on_card else "cpu"
        rec["card"] = card
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        bad = loaded_forbidden()
        if bad:
            print(f"portbench: modules loaded that the benchmark must not "
                  f"load: {bad}", file=err)
            return 4

        outputs = [os.path.join(workdir, f"out{k}.tsv")
                   for k in ["warmup", *range(len(jobs))]]
        t_ref = time.perf_counter()
        exp, checks = judge(ref_mod, traffic, paths, outputs)
        rec["expected"] = exp
        print(f"portbench: {len(jobs)} jobs in {w1 - w0:.3f} s, reference "
              f"{time.perf_counter() - t_ref:.3f} s, {exp['pairs']} pairs",
              file=err)

        expected = traffic.get("card_kernels", []) if on_card else []
        if expected:
            checks["jobs_off_card"] = {
                "value": jobs_off_card(launched, expected), "limit": 0}
        failed = sum(not j["ok"] for j in jobs)
        correct = failed == 0 and all(
            v["value"] <= v["limit"] for v in checks.values())
        metrics = {}
        for entry in metrics_of(c["manifest"], workload, trace):
            value = reader(root, entry["name"])(rec)
            if value is None:
                print(f"portbench: metric {entry['name']} read nothing "
                      f"in {workload}", file=err)
                return 5
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        device = {"platform": "gpu" if on_card else "cpu", "kind": card,
                  "count": wl["chips"] if on_card else 0,
                  "memory_peak_bytes": peak}
        used = sorted({n for j in launched for n, v in j.items() if v})
        per_job = {n: sum(j[n] for j in launched[1:]) / len(jobs)
                   for n in used}
        result = {"correct": correct, "attempted": len(jobs),
                  "failed": failed, "metrics": metrics, "device": device,
                  "job_walls_s": [j["wall"] for j in jobs],
                  "launches_per_job": per_job}
        if trace:
            device["busy_s"] = sum(e - s for s, e in rec["busy"])
            device["window_s"] = w1 - w0
            result["breakdown"] = tr.breakdown(rec)
        result[CHECKS_KEY] = checks
        for e in errors[:5]:
            print(f"portbench: job failed: {e}", file=err)
        print(f"portbench: launches a window job {per_job}", file=err)
        for name, v in checks.items():
            print(f"check {name} {v['value']} limit {v['limit']}", file=err)
        print(json.dumps(result), file=out)
        return 0
    finally:
        gc.unfreeze()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    few_threads()
    return execute(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
