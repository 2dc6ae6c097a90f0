"""accumulate_s: the program's accumulate phase lap in modes/overlap.py
(the scores and np.add.at into the matrix), mean a window job (s)."""

from portbench.trace import mean_lap


def read(rec):
    return mean_lap(rec, ("accumulate",))
