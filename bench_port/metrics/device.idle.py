"""device.idle (%): the share of the traced window in which no operation
ran on the card: 1 - (the union of the device activities' intervals) /
the window.  A union, so streams that overlap count once."""


def read(rec):
    if rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
