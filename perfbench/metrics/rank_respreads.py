"""rank_respreads: the RankIndex's respreads (the program's own counter,
its ``epoch``) during the window's batches, mean a batch. A respread
re-spaces every rank and re-gathers the rank tables on the device; nothing
to read on a layout without a RankIndex."""


def read(run):
    counts = [b.respreads for b in run.batches if b.respreads is not None]
    if not counts:
        return None
    return sum(counts) / len(counts)
