"""put_ms: the host write path, ``put_bulk`` (encode, interning, the
RankIndex on rank layouts), mean ms a batch."""


def read(run):
    if not run.batches:
        return None
    return 1000.0 * sum(b.put_s for b in run.batches) / len(run.batches)
