"""converge_idle_share: the share of the converge spans (``put_bulk`` to
the loop's end, every batch) in which no operation ran on the device, from
the device trace, in %."""


def read(run):
    busy = run.busy()
    if busy is None or not run.batches:
        return None
    wall = sum(b.span_ns[1] - b.span_ns[0] for b in run.batches)
    dev = sum(busy.covered(*b.span_ns) for b in run.batches)
    if not dev or not wall:
        return None
    return 100.0 * (1.0 - dev / wall)
