"""ops_per_s: every update and record read the window completed, over the
window's seconds. Updates of a batch that did not reach residual 0 do not
count."""


def read(run):
    if run.window_s <= 0:
        return None
    return (run.writes - run.failed + run.reads) / run.window_s
