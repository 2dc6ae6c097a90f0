"""decode_s: the tile route's host decode of extract_tiles' bit words
into pairs (the spans engine.decode, one a slab), mean a window job
(s)."""

from portbench.spans import mean_span_s, program_spans


def read(rec, spans=None):
    return mean_span_s(rec, program_spans() if spans is None else spans,
                       ("engine.decode",))
