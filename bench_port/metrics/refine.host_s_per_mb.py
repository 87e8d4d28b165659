"""refine.host_s_per_mb (s/Mb): the wall of the program's
indel_refine.host spans (the indel-refine round's host fallback rows,
the long regions the host refine DP solves while the card works), per Mb
of read bases aligned in the window.  Nothing to read in a run whose
program records no such span."""

from bench_port import spans as sp

NAME = "indel_refine.host"


def read(rec):
    spans = sp.of(rec)
    if not spans or rec.mb <= 0:
        return None
    host = [s for s in spans if s.name == NAME]
    return sum(s.wall_ns for s in host) / 1e9 / rec.mb if host else None
