"""route_host_idle: the share of the traced window in which the card is
idle (outside the union of the profiler's device intervals) while the
tile route's host work runs: the spans engine.pack_keys,
engine.worklist, engine.decode, engine.distances and engine.diagonal
of the window's jobs, in %. None without device activity."""

from portbench.spans import intervals, overlap_s, program_spans

HOST = ("engine.pack_keys", "engine.worklist", "engine.decode",
        "engine.distances", "engine.diagonal")


def read(rec, spans=None):
    busy = rec.get("busy")
    if not busy:
        return None
    host = intervals(rec, program_spans() if spans is None else spans,
                     HOST)
    if host is None:
        return None
    lo, hi = rec["window"]
    idle = sum(e - s for s, e in host) - overlap_s(host, busy)
    return 100.0 * idle / (hi - lo)
