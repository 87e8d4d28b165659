"""stream.overlap (x): stage time summed over every batch of the window
(the program's Timing totals), over the window's wall.  About 1 means
the -t N pool overlaps nothing; W workers at most give W."""


def read(rec):
    total = sum(rec.stage_totals.values())
    return total / rec.window_s if total > 0 and rec.window_s > 0 else None
