"""match_roofline: the least time the card could take for the window's
matching work (portbench/bound.py, counted from the inputs and the
reference's pairs), over the summed device time of every kernel the
window's jobs ran (torch.profiler), in %. None without kernels."""

from portbench.bound import match_bound


def read(rec):
    lo, hi = rec["window"]
    kernel_s = sum(min(e, hi) - max(s, lo)
                   for cat, _n, s, e in rec.get("device_events", ())
                   if cat == "kernel" and e > lo and s < hi)
    if kernel_s <= 0:
        return None
    bound = match_bound(rec["expected"], rec["card"])["bound_s"]
    return 100.0 * bound * len(rec["jobs"]) / kernel_s
