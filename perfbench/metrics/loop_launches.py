"""loop_launches: the port's kernel launches (its own counter,
``bullet_tpu_torch._build.LAUNCHES``) during ``run_until_converged``, mean
a batch. Nothing to read where no kernel launched (the plain versions on
the CPU)."""


def read(run):
    total = sum(b.launches for b in run.batches)
    if not total:
        return None
    return total / len(run.batches)
