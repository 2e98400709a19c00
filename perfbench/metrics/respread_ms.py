"""respread_ms: the mean duration of the program's ``apply.respread``
spans in the window, in ms: a RankIndex respread's device re-gather (its
LUTs built and copied, ``apply.respread.luts``, then the re-gather,
``apply.respread.regather``). Nothing to read where no respread ran."""

from perfbench.spans import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    ns = [s.end_ns - s.start_ns for s in spans if s.name == "apply.respread"]
    if not ns:
        return None
    return sum(ns) / len(ns) / 1e6
