"""loop_stripe_steps: the stripes the round loop's frontier steps were
launched over, a batch: the ``stripe_steps`` count of the program's
``loop`` spans (``ops/packed.py``), summed over each batch, mean over the
window's batches. The frontier's work, which ``loop_launches`` does not
see; the same on every run of a seed."""

from perfbench.spans import by_batch, window


def read(run):
    spans = window(run)
    if spans is None or not run.batches:
        return None
    loops = by_batch(run, spans, "loop")
    if not any(loops):
        return None
    return sum(s.attrs.get("stripe_steps", 0) for b in loops for s in b) / len(run.batches)
