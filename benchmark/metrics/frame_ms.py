"""frame_ms: the window's wall time (host clock, at least ``--seconds``)
over the frames it completed.  The window starts at the first frame's start
and ends at the last frame's ``torch.cuda.synchronize()``."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.seconds / len(w.frame_s) if w.frame_s else None
