"""host.cpu_s_per_mb (s/Mb): the thread CPU seconds of the program's
host-stage spans (the stage spans whose label lacks " (device)": the
labels of host.s_per_mb), per Mb of read bases aligned in the window.
Against host.s_per_mb, the part of a host stage's wall its thread ran."""

from bench_port import spans as sp


def read(rec):
    spans = sp.of(rec)
    if not spans or rec.mb <= 0:
        return None
    st = [s for s in sp.of_kind(spans, "stage")
          if not s.name.endswith(sp.DEVICE)]
    return sum(s.cpu_ns for s in st) / 1e9 / rec.mb if st else None
