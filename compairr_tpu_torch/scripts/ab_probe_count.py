"""A/B probe: count_tiles on the mixed tiles of a 2M-row indel worklist.

Run through ab_compare.py, which passes the tree as argv[1]; prints
`ABRESULT <best-seconds> checksum=... tiles=...`. It times
kernels.count_tiles on the tiles that hold both equal-key and key
distance 1 pairs (the indel class) of a 2,000,001-row -d 1 -i
self-comparison at tile 512, column-major, as find_pairs launches them;
the data comes from the tree's bench (the same seeds in every tree).
The device is COMPAIRR_DEVICE's, by default the card; the card is
synchronised before the clock is read.

Env knobs: AB_N (rows, default 2,000,001), AB_TILES (worklist cap,
default 65,536), AB_REPEATS (timed repeats, default 3).
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
    from compairr_tpu_torch.ops import engine as E
    from compairr_tpu_torch.ops import kernels as K
    from compairr_tpu_torch.utils.device import resolve_device

    n = int(os.environ.get("AB_N", 2_000_001))
    max_tiles = int(os.environ.get("AB_TILES", 65_536))
    repeats = int(os.environ.get("AB_REPEATS", 3))
    dev = resolve_device()
    d1 = bench.synth_arrays(n, n_reps=60, n_v=48, n_j=13, seed=21)
    bench._plant_near_dups(d1, d1, 0.01, seed=23)  # a nonzero checksum
    tile = 512
    lmax = E._round_up(int(d1.longest), 8)
    order, key, npad = E.pack_keys(d1, tile, True)
    rows = K.device_rows_raw(d1, order, npad, lmax, True, key, 0, dev,
                             wide=K.wide_keys(key[: d1.n]),
                             planes=dev.type == "cuda")
    work = E.worklist_from_keys(key, d1.n, key, d1.n, 1, tile, tile)
    has_eq, has_pm = E.classify_worklist(work, key, d1.n, key, d1.n, tile,
                                         tile)
    mixed = E.order_colmajor(work[has_eq & has_pm])[:max_tiles]
    print("tiles total", len(work), "mixed", len(mixed), flush=True)
    kw = dict(differences=1, exclude_self=True, tile_m=tile, tile_n=tile,
              cls=K.CLS_BOTH)
    c = K.count_tiles(rows, rows, K.upload_worklist(mixed[:1024], dev),
                      **kw)
    _sync(dev)  # warm: the kernel's lazy build and first launch
    work_dev = K.upload_worklist(mixed, dev)
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        c = K.count_tiles(rows, rows, work_dev, **kw)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    checksum = int(c.sum())
    print(f"ABRESULT {best:.6f} checksum={checksum} tiles={len(mixed)} "
          f"per_tile_us={best / max(len(mixed), 1) * 1e6:.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
