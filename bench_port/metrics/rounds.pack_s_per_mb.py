"""rounds.pack_s_per_mb (s/Mb): devstats' pack_s summed over every device
round of the window (host time from a round's entry until every bucket
is launched: packing, host-to-device copies, the wrappers, the host
jobs), per Mb."""


def read(rec):
    pack = sum(a.get("pack_s", 0.0) for a in rec.devstats.values())
    return pack / rec.mb if pack > 0 and rec.mb > 0 else None
