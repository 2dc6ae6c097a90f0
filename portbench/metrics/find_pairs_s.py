"""find_pairs_s: the program's find_pairs phase lap in modes/overlap.py,
mean a window job (s). It ends in host arrays, so the device work is
inside it; the tile route is started on a worker during the duplicate
phase (prefetch_find_pairs), so this reads the part not hidden."""

from portbench.trace import mean_lap


def read(rec):
    return mean_lap(rec, ("find_pairs",))
