"""parse_s: the program's read1 + read2 phase laps (modes/overlap.py,
io/airr.py and io/native.py: both sets' parse), mean a window job (s)."""

from portbench.trace import mean_lap


def read(rec):
    return mean_lap(rec, ("read1", "read2"))
