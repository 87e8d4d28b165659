"""stream.self_s_per_mb (s/Mb): the batches' host time outside every
Timing stage (read encoding before the first stage, SAM formatting after
the last): the sum over batch spans of the batch's wall less the union
of its stage spans, per Mb of read bases aligned in the window."""

from collections import defaultdict

from bench_port import spans as sp
from bench_port.harness import union


def read(rec):
    spans = sp.of(rec)
    if not spans or rec.mb <= 0:
        return None
    batches = sp.of_kind(spans, "batch")
    if not batches:
        return None
    stages = defaultdict(list)
    for s in sp.of_kind(spans, "stage"):
        stages[s.parent].append(s)
    self_ns = 0
    for b in batches:
        inside = [(max(s.t0_ns, b.t0_ns), min(s.t1_ns, b.t1_ns))
                  for s in stages[b.id]]
        self_ns += b.wall_ns - sum(e - s for s, e in union(inside) if e > s)
    return self_ns / 1e9 / rec.mb
