"""worklist_s: the tile route's host worklist on its worker thread: the
key sort (engine.pack_keys) and worklist_from_keys, classify_worklist
and order_colmajor (engine.worklist), mean a window job (s)."""

from portbench.spans import mean_span_s, program_spans


def read(rec, spans=None):
    return mean_span_s(rec, program_spans() if spans is None else spans,
                       ("engine.pack_keys", "engine.worklist"))
