"""kernels.roofline (%): the hand kernels' roofline time (each call's
least time on the card from roofline/<kernel>.py's operations and bytes,
peaks.py's rates), summed over every call of the window, over their
device time in the profiler's trace.  Nothing to read when no hand
kernel ran."""


def read(rec):
    dev = sum(rec.hand_device_s.values())
    if dev <= 0:
        return None
    return 100.0 * sum(rec.hand_bound_s.values()) / dev
