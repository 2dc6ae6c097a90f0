"""The program's own span record, read for the per-layer metrics.

compairr_tpu_torch.utils.trace keeps one span tree a CLI job while
COMPAIRR_TIMING=1, which a traced run sets: each span has a name, an
id, its parent's and its job's ids, its thread, its start and end on
time.perf_counter_ns() (the harness's clock, in ns) and a dict of
counts. The metrics read the jobs whose job span starts inside the
window, and read nothing (None) where that count of jobs differs from
the window's, or where the program keeps no such record.
"""

from __future__ import annotations

from .trace import union


def program_spans():
    """The program's spans, or None where it keeps none."""
    try:
        from compairr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans()


def window_jobs(rec: dict, spans) -> dict | None:
    """{job id: its spans} of the jobs that started inside the window;
    None where they are not one a window job."""
    if spans is None:
        return None
    lo, hi = rec["window"]
    jobs = {s.id: [] for s in spans if s.name == "job"
            and s.parent is None and lo <= s.t0 / 1e9 <= hi}
    if not jobs or len(jobs) != len(rec["jobs"]):
        return None
    for s in spans:
        if s.job in jobs:
            jobs[s.job].append(s)
    return jobs


def mean_span_s(rec: dict, spans, names: tuple):
    """Mean seconds a window job spent in the spans named names
    (summed); None where no window job has one."""
    jobs = window_jobs(rec, spans)
    if jobs is None:
        return None
    got = [s.t1 - s.t0 for ss in jobs.values() for s in ss
           if s.name in names and s.t1 is not None]
    return sum(got) / 1e9 / len(jobs) if got else None


def count_sum(rec: dict, spans, name: str, key: str):
    """The count key of the spans named name, summed over the window's
    jobs; None where none has it."""
    jobs = window_jobs(rec, spans)
    if jobs is None:
        return None
    got = [s.counts[key] for ss in jobs.values() for s in ss
           if s.name == name and key in s.counts]
    return sum(got) if got else None


def intervals(rec: dict, spans, names: tuple):
    """The merged intervals (s) of the window jobs' spans named names,
    clipped to the window; None where no window job has one."""
    jobs = window_jobs(rec, spans)
    if jobs is None:
        return None
    got = [(s.t0 / 1e9, s.t1 / 1e9) for ss in jobs.values() for s in ss
           if s.name in names and s.t1 is not None]
    return union(got, *rec["window"]) if got else None


def overlap_s(a: list, b: list) -> float:
    """Seconds in both of two merged, ordered interval lists."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out
