"""graph_rounds: the gossip rounds a converge takes on a topology other than
a ring, a chain or a full mesh (BASELINE.json's north star, "gossip rounds
to convergence"): the ``steps`` count of the program's ``loop`` spans that
ran the graph pass (those that count the neighbour list's ``edges``),
summed over each batch, mean over the window's batches. Nothing to read
where no ``loop`` span counts edges (a program without the graph pass)."""

from perfbench.spans import by_batch, window


def read(run):
    spans = window(run)
    if spans is None or not run.batches:
        return None
    passes = [[s for s in b if "edges" in s.attrs] for b in by_batch(run, spans, "loop")]
    if not any(passes):
        return None
    return sum(s.attrs.get("steps", 0) for b in passes for s in b) / len(run.batches)
