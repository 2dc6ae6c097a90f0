"""dense_roofline: the least time the card could take for the window's
matching work (portbench/bound.py, counted from the inputs and the
reference's pairs), over the summed device time of the dense engine's
kernels (torch.profiler's kernels whose name holds dense_match_kernel,
dense_join_kernel or dense_onehot_kernel: whichever of them the plan
picks, at every instantiation), in %. None without such kernels."""

from portbench.bound import match_bound

KERNELS = ("dense_match_kernel", "dense_join_kernel", "dense_onehot_kernel")


def read(rec):
    lo, hi = rec["window"]
    kernel_s = sum(min(e, hi) - max(s, lo)
                   for cat, name, s, e in rec.get("device_events", ())
                   if cat == "kernel" and any(k in name for k in KERNELS)
                   and e > lo and s < hi)
    if kernel_s <= 0:
        return None
    bound = match_bound(rec["expected"], rec["card"])["bound_s"]
    return 100.0 * bound * len(rec["jobs"]) / kernel_s
