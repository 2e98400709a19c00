"""apply_ms: ``step(0)`` (the host reduction and the flat apply) to the
device drained, mean ms a batch."""


def read(run):
    if not run.batches:
        return None
    return 1000.0 * sum(b.apply_s for b in run.batches) / len(run.batches)
