"""stream.batch_p90_ms (ms): the 90th percentile, over every batch of the
traced window, of the time from align_stream taking the batch from its
iterator to its SAM lines coming back.  Read here, beside the rate it
moves, and not bounded end to end: hifi.t4's window holds under the 100
batches ten samples past p90 need."""

import numpy as np


def read(rec):
    lat = rec.latencies_ms
    return float(np.percentile(lat, 90)) if len(lat) else None
