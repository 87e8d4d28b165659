"""chain.far_s_per_mb (s/Mb): the wall of the program's chain_sdp.far
spans (the host work the windowed chaining kernel adds to its round: the
far-term schedules it is given, then the FAR sentinels resolved after
it), per Mb of read bases aligned in the window.  Nothing to read in a
run whose program records no such span."""

from bench_port import spans as sp

NAME = "chain_sdp.far"


def read(rec):
    spans = sp.of(rec)
    if not spans or rec.mb <= 0:
        return None
    far = [s for s in spans if s.name == NAME]
    return sum(s.wall_ns for s in far) / 1e9 / rec.mb if far else None
