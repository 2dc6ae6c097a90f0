"""decode_s: the tile route's copy back of extract_tiles' pairs (the span
engine.decode: each card's int32 pairs of original indices joined,
copied to the host once and widened to int64), mean a window job (s)."""

from portbench.spans import mean_span_s, program_spans


def read(rec, spans=None):
    return mean_span_s(rec, program_spans() if spans is None else spans,
                       ("engine.decode",))
