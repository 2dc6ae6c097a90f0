"""Allocator tuning for large-array workloads.

glibc releases every big allocation back to the kernel on free
(mmap/munmap per array), so each pipeline phase re-faults hundreds of
MB of anonymous pages. On bare metal that costs ~0.1 s/GB; on the
ballooned VMs this framework is deployed on, anonymous-fault
throughput intermittently collapses ~100x (observed 20-60 MB/s), and
the munmap/re-mmap churn then dominates end-to-end wall time.

retain_heap() raises glibc's M_MMAP_THRESHOLD and M_TRIM_THRESHOLD so
large blocks are served from the retained heap: pages are faulted
once and reused at memory speed for the rest of the process. Peak RSS
is unchanged (retention keeps RSS *at* the peak rather than below it
between phases). COMPAIRR_MALLOC_RETAIN=0 disables.
"""

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def retain_heap(limit_bytes: int = 1 << 30) -> bool:
    """Keep allocations below limit_bytes on the glibc heap and never
    trim it. Returns True when the tuning took effect."""
    global _done
    if _done:
        return True
    if os.environ.get("COMPAIRR_MALLOC_RETAIN") == "0":
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(_M_MMAP_THRESHOLD, limit_bytes)
        ok &= libc.mallopt(_M_TRIM_THRESHOLD, limit_bytes)
    except (OSError, AttributeError):
        return False
    _done = bool(ok)
    return _done
