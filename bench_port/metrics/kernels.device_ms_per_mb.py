"""kernels.device_ms_per_mb (ms/Mb): the hand kernels' device time in the
profiler's trace, per Mb of read bases."""


def read(rec):
    dev = sum(rec.hand_device_s.values())
    return 1e3 * dev / rec.mb if dev > 0 and rec.mb > 0 else None
