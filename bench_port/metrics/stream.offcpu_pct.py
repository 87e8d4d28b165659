"""stream.offcpu_pct (%): the share of the stage spans' wall in which
their thread neither ran nor waited for the card: 100 x [sum over stage
spans of (wall - CPU) - sum over the rounds' .wait and .copy phases of
(wall - CPU)] / sum of the stage spans' wall.  At W workers, mostly the
wait for the interpreter lock."""

from bench_port import spans as sp


def read(rec):
    spans = sp.of(rec)
    if not spans:
        return None
    st = sp.of_kind(spans, "stage")
    wall = sum(s.wall_ns for s in st)
    if wall <= 0:
        return None
    off = sum(s.wall_ns - s.cpu_ns for s in st)
    device = sum(s.wall_ns - s.cpu_ns for s in sp.of_kind(spans, "phase")
                 if s.name.endswith((".wait", ".copy")))
    return 100.0 * (off - device) / wall
