"""95th percentile of the ms from each frame's due time (the play's start
+ index / fps) to its arrival at the subscriber, over every frame due in
the window: the lag the streamer's pacing lets grow, with the read and the
tracker at batch 1."""

import math


def read(rec):
    value = rec.get("lag_p95_ms")
    return value if value is not None and math.isfinite(value) else None
