"""qps: every query answered in the window over the window's seconds (the
window ends when its last call returns)."""


def read(run):
    return run.rec.answered / run.rec.window_s if run.rec.window_s > 0 and run.rec.answered else None
