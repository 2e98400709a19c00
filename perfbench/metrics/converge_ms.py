"""converge_ms: the mean over the window's batches of the time from the
``put_bulk`` call to ``run_until_converged`` returning, the device drained:
how long a write stays stale at some replica."""


def read(run):
    if not run.batches:
        return None
    return 1000.0 * sum(b.converge_s for b in run.batches) / len(run.batches)
