"""device_peak_gib: torch.cuda.max_memory_allocated() over the window,
reset just before it (GiB). None off the card."""


def read(rec):
    if not rec["on_card"]:
        return None
    return rec["window_peak_bytes"] / 2**30
