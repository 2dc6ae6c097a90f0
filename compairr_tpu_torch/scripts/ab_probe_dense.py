"""A/B probe: the dense kernel at the bench kernel section's shape.

Run through ab_compare.py, which passes the tree as argv[1]; prints
`ABRESULT <best-seconds> checksum=... tiles=...`. It runs the tree's
bench.prepared_dense (the plan, both sides and the worklist made once),
then times AB_REPS calls queued back to back, the card synchronised
before the clock is read; the per-tree checksum must agree, so the A/B
also shows that a change kept the answers. The device is
COMPAIRR_DEVICE's, by default the card.

Env knobs: AB_NK (rows a side, default 1,000,000), AB_TILE (default
768), AB_REPS (calls a timed batch, default 8), AB_ROUNDS (timed
batches, default 3), AB_INDELS=1 (a -d 1 -i run: dense_indel).
"""

import os
import sys
import time


def _sync(dev):
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def main(argv):
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    import compairr_tpu_torch

    if not compairr_tpu_torch.__file__.startswith(tree):
        raise SystemExit(
            f"{compairr_tpu_torch.__file__} is not under {tree}")
    from compairr_tpu_torch import bench
    from compairr_tpu_torch.utils.device import resolve_device

    n = int(os.environ.get("AB_NK", 1_000_000))
    tile = int(os.environ.get("AB_TILE", 768))
    reps = int(os.environ.get("AB_REPS", 8))
    rounds = int(os.environ.get("AB_ROUNDS", 3))
    indels = os.environ.get("AB_INDELS") == "1"
    dev = resolve_device()
    d1, d2 = bench.kernel_sets(n)
    run, plan, _, _ = bench.prepared_dense(d1, d2, tile, dev, indels=indels)
    _sync(dev)
    t0 = time.perf_counter()
    out = run()  # warm: the kernel's lazy build and first launch
    _sync(dev)
    compile_s = time.perf_counter() - t0
    checksum = float(out.sum().item())

    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / reps)

    print(f"ABRESULT {best:.6f} checksum={checksum} tiles={len(plan.work)} "
          f"kernel={plan.kind} compile={compile_s:.1f}")


if __name__ == "__main__":
    main(sys.argv[1:])
