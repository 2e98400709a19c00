"""loop_columns: the dirty columns the round loop settled in one column
pass, a batch: the ``columns`` count of the program's ``loop`` spans
(``ops/packed.py`` ``gossip_columns_packed``; the stripe loops count 0),
summed over each batch, mean over the window's batches. Over the batch's
distinct leaves written, it is the share of converges that took the pass.
Nothing to read where no ``loop`` span counts columns (a program without
the column pass)."""

from perfbench.spans import by_batch, window


def read(run):
    spans = window(run)
    if spans is None or not run.batches:
        return None
    loops = [s for b in by_batch(run, spans, "loop") for s in b]
    if not any("columns" in s.attrs for s in loops):
        return None
    return sum(s.attrs.get("columns", 0) for s in loops) / len(run.batches)
