"""k7.roofline (%): K7's roofline time (roofline/k7_windowed.py's
operations and bytes of each call's real problems, at peaks.py's rates),
summed over its calls in the window, over K7's device time in the
profiler's trace.  Nothing to read when K7 did not run."""

KERNEL = "k7_windowed"


def read(rec):
    dev = rec.hand_device_s.get(KERNEL, 0.0)
    if dev <= 0:
        return None
    return 100.0 * rec.hand_bound_s.get(KERNEL, 0.0) / dev
