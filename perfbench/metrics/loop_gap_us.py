"""loop_gap_us: the device's idle time inside the program's ``loop`` spans
(the round loop of ``run_until_converged``), from the device trace, over
the frontier steps they launched (their ``steps`` count), in us a step:
the host's round trip a step, reading the ids' tail and launching the
next."""

from perfbench.spans import window


def read(run):
    busy = run.busy()
    spans = window(run)
    if busy is None or spans is None:
        return None
    loops = [s for s in spans if s.name == "loop"]
    steps = sum(s.attrs.get("steps", 0) for s in loops)
    if not steps:
        return None
    idle = sum(s.end_ns - s.start_ns - busy.covered(s.start_ns, s.end_ns) for s in loops)
    return idle / 1e3 / steps
