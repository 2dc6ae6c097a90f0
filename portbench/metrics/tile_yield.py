"""tile_yield: worklist tiles with a match over the tiles count_tiles
counted (the counts tiles_matched and tiles of the tile route's count
phase, the span engine.count), summed over the window's jobs, in %."""

from portbench.spans import count_sum, program_spans


def read(rec, spans=None):
    spans = program_spans() if spans is None else spans
    tiles = count_sum(rec, spans, "engine.count", "tiles")
    matched = count_sum(rec, spans, "engine.count", "tiles_matched")
    if not tiles or matched is None:
        return None
    return 100.0 * matched / tiles
