"""What a traced run (--trace 1) records, and the reduction from it.

Host phases come from the program's own phase timer
(compairr_tpu_torch.ops.engine._PhaseTimer, on under COMPAIRR_TIMING=1):
each lap is recorded with its thread, label, start and end on the host
clock. Device activity comes from torch.profiler's CUDA activity,
exported as a Chrome trace; its clock is tied to the host clock by the
harness's own span around each job (record_function "portbench.job").
All times in the record are seconds on time.perf_counter's clock.
"""

from __future__ import annotations

import json
import statistics
import threading

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_SPAN = "portbench.job"


class PhaseRecorder:
    """Records every lap of the program's phase timer while active, as
    (thread ident, label, start, end). Raises where the program has no
    such timer: the per-layer metrics would then read nothing."""

    def __init__(self):
        self.laps: list = []

    def __enter__(self):
        from compairr_tpu_torch.ops import engine

        self._cls = getattr(engine, "_PhaseTimer", None)
        if self._cls is None or not hasattr(self._cls, "lap"):
            raise RuntimeError("compairr_tpu_torch.ops.engine has no "
                               "_PhaseTimer.lap: the traced run reads the "
                               "program's phases from it")
        self._orig = self._cls.lap
        laps, orig = self.laps, self._orig

        def lap(timer, label):
            start = timer._t
            orig(timer, label)
            if timer.enabled:
                laps.append((threading.get_ident(), label, start, timer._t))

        self._cls.lap = lap
        return self

    def __exit__(self, *exc):
        self._cls.lap = self._orig
        return False


def device_events(trace_path: str, job_starts: list) -> list:
    """(category, name, start, end) of every kernel, copy and memset in
    the Chrome trace, on the host clock: the offset is the median gap
    between each job's span in the trace and its start as the harness
    read it. Raises where the trace does not hold one span a job."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted(e["ts"] for e in events
                   if e.get("name") == JOB_SPAN
                   and e.get("cat") == "user_annotation")
    if not spans or len(spans) != len(job_starts):
        raise RuntimeError(f"the trace holds {len(spans)} {JOB_SPAN} "
                           f"spans for {len(job_starts)} jobs")
    offset = statistics.median(
        ts / 1e6 - t for ts, t in zip(spans, job_starts))
    return sorted(
        (e["cat"], e["name"], e["ts"] / 1e6 - offset,
         (e["ts"] + e.get("dur", 0)) / 1e6 - offset)
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    )


def union(intervals: list, lo: float, hi: float) -> list:
    """The intervals clipped to [lo, hi] and merged, in order."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_phase(busy: list, lo: float, hi: float, phases: list) -> dict:
    """Seconds of [lo, hi] with the device idle, by the label of the
    host phase then open on the main thread ("outside phases" for the
    rest)."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    out: dict = {}
    total = 0.0
    for label, ps, pe in phases:
        for gs, ge in gaps:
            d = min(ge, pe) - max(gs, ps)
            if d > 0:
                out[label] = out.get(label, 0.0) + d
                total += d
    rest = sum(ge - gs for gs, ge in gaps) - total
    if rest > 0:
        out["outside phases"] = rest
    return out


def breakdown(rec: dict) -> dict:
    """The ten device operations with the most time in the window, and
    the ten host phases with the most device idle time."""
    lo, hi = rec["window"]
    ops: dict = {}
    for _cat, name, s, e in rec["device_events"]:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            ops[name] = ops.get(name, 0.0) + d
    idle = idle_by_phase(rec["busy"], lo, hi, rec["main_phases"])
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in top],
            "idle_gaps": [list(kv) for kv in gaps]}


def mean_lap(rec: dict, labels: tuple):
    """Mean seconds a window job spent in the main thread's laps named
    labels (summed); None where the run recorded no such lap."""
    jobs = rec["jobs"]
    if not jobs or "main_phases" not in rec:
        return None
    total, seen = 0.0, False
    for label, s, e in rec["main_phases"]:
        if label in labels and s >= rec["window"][0]:
            total += e - s
            seen = True
    return total / len(jobs) if seen else None
