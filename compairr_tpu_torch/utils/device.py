"""Device choice for the device routes, and the profiler hook.

Device routes (the dense engine, the tile route of find_pairs) run on
CUDA unless the caller asks for the CPU: an explicit device= argument
on the Python entry points, or COMPAIRR_DEVICE=cpu for the CLI. On the
CPU every kernel wrapper takes its plain PyTorch version. A device
route that finds no CUDA device and no CPU request raises; it never
carries on on the CPU.

Host-only routes (dedup, d=0, pigeonhole, variant join) never call
into this module, so they never import torch.
"""

from __future__ import annotations

import contextlib
import os


def resolve_device(device=None):
    """The torch.device a device route runs on: `device` when given,
    else COMPAIRR_DEVICE, else "cuda". Raises RuntimeError when the
    choice is CUDA and no CUDA device is present."""
    import torch

    choice = device if device is not None else os.environ.get(
        "COMPAIRR_DEVICE", "cuda"
    )
    dev = torch.device(choice)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this device route needs a CUDA device and none is "
            "available; pass device='cpu' or set COMPAIRR_DEVICE=cpu to "
            "run it on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev} (use cuda or cpu)")
    return dev


def local_devices(device=None) -> list:
    """The devices a device route may spread over: cuda:0 .. cuda:n-1,
    all local CUDA devices capped by COMPAIRR_DEVICES (only the one named
    when `device` carries an index); [cpu] on the CPU. Multi-device entry
    points also take an explicit device list, which may repeat a device
    (its replicas then share their tensors)."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev]
    n = torch.cuda.device_count()
    try:
        cap = int(os.environ.get("COMPAIRR_DEVICES", "0"))
    except ValueError:
        cap = 0
    n = max(1, min(cap, n)) if cap > 0 else n
    return [torch.device("cuda", i) for i in range(n)]


@contextlib.contextmanager
def profile_trace(profile_dir: str):
    """Trace the run with torch.profiler (CPU and, when present, CUDA
    activity, with the spans of utils.trace as annotations) and write a
    Chrome trace into profile_dir when it exits (the COMPAIRR_PROFILE
    hook)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # every thread's annotations (utils.trace spans), the tile route's
    # worker's included, where this torch can record them
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    with profile(activities=activities, **kw) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{os.getpid()}.json")
    )
