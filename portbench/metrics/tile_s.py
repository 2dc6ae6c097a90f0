"""tile_s: the tile route's card phases, the laps engine.count
(count_tiles' launches and copy back) and engine.extract (extract_tiles'
launches, one a tile class, and the one copy back of their pairs),
summed, mean a window job (s)."""

from portbench.spans import mean_span_s, program_spans


def read(rec, spans=None):
    return mean_span_s(rec, program_spans() if spans is None else spans,
                       ("engine.count", "engine.extract"))
