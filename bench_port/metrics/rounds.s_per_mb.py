"""rounds.s_per_mb (s/Mb): Timing totals of the device rounds (the labels
ending " (device)": SDP rounds, refine boxes, gap-align, indel-refine,
each with its host packing, launches, copy and decoding), per Mb."""


def read(rec):
    dev = sum(v for k, v in rec.stage_totals.items()
              if k.endswith(" (device)"))
    return dev / rec.mb if dev > 0 and rec.mb > 0 else None
