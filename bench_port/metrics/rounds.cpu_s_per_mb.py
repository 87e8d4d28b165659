"""rounds.cpu_s_per_mb (s/Mb): the thread CPU seconds of the program's
device-round stage spans (labels ending " (device)", those of
rounds.s_per_mb), per Mb of read bases aligned in the window."""

from bench_port import spans as sp


def read(rec):
    spans = sp.of(rec)
    if not spans or rec.mb <= 0:
        return None
    st = [s for s in sp.of_kind(spans, "stage")
          if s.name.endswith(sp.DEVICE)]
    return sum(s.cpu_ns for s in st) / 1e9 / rec.mb if st else None
