"""``run.py``'s launcher on the CPU, for the tests: the same ``serve``, with
its processes on the host and joined by gloo in place of NCCL.

    python3 <bench root>/perfbench/cpu_run.py --workload <cell> --seed <n> --seconds <s>
        --trace 0 [--die-at K] [--stall-at K] [--timeout S] [--control cutoff]

The test copies it into a benchmark root beside ``run.py``. ``--die-at K``
kills rank 1 at its K-th converge; ``--stall-at K`` stops it there for
good; ``--timeout S`` sets every process's collective timeout;
``--control cutoff`` runs the control through the same launcher
(``launch.spmd``, as ``readings.py`` does) and prints its result.
"""

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from perfbench import launch, run

    argv = sys.argv[1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("--die-at", type=int)
    ap.add_argument("--stall-at", type=int)
    ap.add_argument("--timeout", type=float)
    ap.add_argument("--control", choices=("cutoff",))
    extra, rest = ap.parse_known_args(argv)
    args = run.parse(rest)
    if args.rank is not None:
        launch.die_with_parent()
    if extra.timeout:
        launch.TIMEOUT_S = extra.timeout
    if args.rank == 1 and (extra.die_at or extra.stall_at):
        from bullet_tpu_torch.models.netsim import PeerNetworkSim

        orig, calls = PeerNetworkSim.run_until_converged, []

        def converge(self, max_rounds=None):
            calls.append(1)
            if len(calls) == extra.die_at:
                os.kill(os.getpid(), signal.SIGKILL)
            while len(calls) == extra.stall_at:
                time.sleep(1)
            return orig(self, max_rounds)

        PeerNetworkSim.run_until_converged = converge
    if extra.control:
        from perfbench import harness

        def body(device):
            return harness.run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                                    device=device, control=extra.control, log=lambda m: None)

        res = launch.spmd(args, argv, __file__, launch.world(ROOT, args.workload), "cpu", "gloo",
                          body)
        if res is not None:
            print(json.dumps(res))
        return 0
    return run.serve(args, argv, __file__, "cpu", "gloo")


if __name__ == "__main__":
    sys.exit(main())
