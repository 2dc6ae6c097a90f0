"""dense_s: the dense engine's laps of dense_matrix (ops/engine.py): the
plan (engine.plan: both sides' key sort and the worklist), the derive
(engine.derive) and the kernel and its copy back (engine.kernel),
summed, mean a window job (s). None without those spans."""

from portbench.spans import mean_span_s, program_spans


def read(rec, spans=None):
    return mean_span_s(rec, program_spans() if spans is None else spans,
                       ("engine.plan", "engine.derive", "engine.kernel"))
