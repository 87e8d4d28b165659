"""host.s_per_mb (s/Mb): Timing totals of the host stages (every label
without " (device)": anchors, clustering, chain surgery, gap splicing,
scoring and MAPQ), per Mb of read bases aligned in the window."""


def read(rec):
    host = sum(v for k, v in rec.stage_totals.items()
               if not k.endswith(" (device)"))
    return host / rec.mb if host > 0 and rec.mb > 0 else None
