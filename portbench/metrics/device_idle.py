"""device_idle: the share of the traced window with no kernel, copy or
memset on the card (the union of the profiler's device intervals), in %.
None where the trace holds no device activity."""


def read(rec):
    busy = rec.get("busy")
    if not busy:
        return None
    lo, hi = rec["window"]
    return 100.0 * (1.0 - sum(e - s for s, e in busy) / (hi - lo))
