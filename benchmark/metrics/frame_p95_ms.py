"""frame_p95_ms: the 95th percentile (linear interpolation) of every frame
of the window.  Each frame is timed by two CUDA events on the card, one
recorded as the frame starts (the card is idle then: the previous frame
ended in a synchronize) and one after its last launch, so a frame's time
counts every gap the host leaves inside it, read on the card's clock."""

import numpy as np


def read(ctx):
    t = ctx.window.frame_s
    return 1e3 * float(np.percentile(t, 95)) if t else None
