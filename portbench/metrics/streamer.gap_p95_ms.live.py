"""95th percentile of the ms between consecutive frames the subscriber
received in the window (the streamer's read, the tracker at batch 1 and
the hand-over)."""

import numpy as np


def read(rec):
    gaps = rec["gaps"]
    return 1e3 * float(np.percentile(gaps, 95)) if len(gaps) and np.isfinite(gaps).all() else None
