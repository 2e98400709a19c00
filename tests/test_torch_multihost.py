"""The port's mesh across OS processes (``parallel/multihost.py``): two gloo
processes of two CPU shards each (tests/_torch_multihost_worker.py), held
against the reference computed here, in the pytest process, on the same
seeded numpy inputs, which reach the workers in a temporary npz, so that
the workers import no JAX.

* the six families of tests/_multihost_worker.py (a dense ring round, the
  packed frontier loop at fuse 1, the packed reconcile, the packed window
  frontier at window_fuse = 5, the dense frontier at HALO_FUSE, the rank
  and rank1 frontier and reconcile, ring_window_shardmap_packed at m = 3
  and 8): each process's shards against the reference's unsharded result,
  with round counts, changed counts and residuals;
* a seeded op sequence (puts, put_bulk, step, fast_forward,
  run_until_converged with and without a cutoff, converged(), reconcile,
  get and get_bulk at peers of both processes, a count query) on dense
  lww, packed, rank and rank1 sims, on a ring and a chain, with
  use_shard_map and on a data mesh, two cells on the card's fused routes
  (HALO_FUSE, the windows), and a full mesh, a star and a bridge (the
  doubling, the hub reduce, the gathers), against the reference's sim on
  four devices: after every op the return value, ``last_residual`` and each
  process's shards; the rank layouts' RankIndex the same in both
  processes and the reference's;
* host_info, is_multihost, a second initialize_multihost, and a process
  that dies before a collective failing its peer within the group's
  timeout.

Tolerance: exact."""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

import _torch_multihost_worker as worker

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")

FAMILIES = (
    "dense ring_round_shardmap", "packed frontier fuse 1", "packed reconcile",
    "packed window frontier m 5", "dense frontier HALO_FUSE", "rank frontier",
    "rank reconcile", "rank1 frontier", "rank1 reconcile", "rank1 ring_window m 3 and 8",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(path, out_dir, mode="all", timeout=150):
    """Both workers; (return codes, outputs, seconds until each ended). A
    worker that fails gets the other killed (in the failure modes, where
    rank 1 ends on purpose, only rank 0's failure does)."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"
    started = time.perf_counter()
    ended, outputs = [None, None], []
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(open(os.path.join(out_dir, f"worker{rank}.log"), "w+"))
                for rank in (0, 1)]
        procs = [subprocess.Popen([sys.executable, _WORKER, coordinator, str(rank), str(path),
                                   str(out_dir), mode], cwd=_REPO, env=env,
                                  stdout=log, stderr=subprocess.STDOUT)
                 for rank, log in zip((0, 1), logs)]
        try:
            while None in ended and time.perf_counter() - started < timeout:
                for rank, p in enumerate(procs):
                    if ended[rank] is None and p.poll() is not None:
                        ended[rank] = time.perf_counter() - started
                watched = procs if mode == "all" else procs[:1]
                if any(p.returncode not in (None, 0) for p in watched):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
    if None in ended and all(p.returncode in (0, -9) for p in procs):
        pytest.fail("multihost workers timed out:\n" + "\n".join(outputs))
    return [p.returncode for p in procs], outputs, ended


# ------------------------------------------------- the reference's side


def family_cases(out: dict) -> None:
    """Inputs and expected results of the six families, as the reference's
    worker builds them (tests/_multihost_worker.py), unsharded."""
    from bullet_tpu.ops.merge import TableState
    from bullet_tpu.ops.packed import (
        PackedTable,
        frontier_tile_n,
        gossip_frontier_packed,
        gossip_round_ring_packed,
        pack_cv,
        reconcile_packed_xla,
    )
    from bullet_tpu.ops.rank import Rank1Table, RankIndex, RankTable, pack_to_rank
    from bullet_tpu.parallel import topology as topo
    from bullet_tpu.parallel.gossip import gossip_round_ring, gossip_until_converged_device

    rng = np.random.default_rng(0)

    def dense(p, n):
        cls = rng.integers(0, 4, (p, n), dtype=np.int32)
        fields = [cls]
        for lo, hi in ((-50, 50), (-50, 50), (0, 30), (0, p), (0, 9), (0, 5)):
            fields.append(np.where(cls > 0, rng.integers(lo, hi, (p, n)), 0).astype(np.int32))
        return np.stack(fields)

    def arrays(t):
        return np.stack([np.asarray(f) for f in t])

    out["dense8"] = dense(8, 64)
    merged, changed = gossip_round_ring(TableState(*map(jnp.asarray, out["dense8"])), "reference")
    out["dense8_out"], out["dense8_changed"] = arrays(merged), np.int64(changed)

    pp, nn = 32, 256
    cls = rng.integers(0, 4, (pp, nn), dtype=np.int32)
    present = cls > 0
    khi = np.where(present, rng.integers(-50, 50, (pp, nn)), 0).astype(np.int32)
    klo = np.where(present, rng.integers(-50, 50, (pp, nn)), 0).astype(np.int32)
    vid = np.where(present, rng.integers(1, 1 << 16, (pp, nn)), 0).astype(np.int32)
    cv = np.asarray(pack_cv(jnp.asarray(cls), jnp.asarray(vid)))
    out["packed"] = np.stack([khi, klo, cv])
    ridx = RankIndex()
    n_vals = 1 << 16
    ridx.insert_batch(np.arange(n_vals), np.ones(n_vals, np.int32), np.zeros(n_vals, np.int32),
                      np.arange(n_vals, dtype=np.int32))
    rank = np.asarray(pack_to_rank(PackedTable(*map(jnp.asarray, out["packed"])),
                                   jnp.asarray(ridx.rank_map())).rank)
    # cv's class is the index's (1) where the reference's worker keeps the
    # random one: a rank then names one entry, as in a sim, and the joins
    # of the two packages need not break ties between entries of one rank
    # alike
    out["rank"] = np.stack([rank, np.asarray(pack_cv(jnp.asarray(present.astype(np.int32)),
                                                     jnp.asarray(vid)))])
    out["rank1"] = rank[None]
    t_loc = nn // frontier_tile_n(pp, nn)
    for key, ctor in (("packed", PackedTable), ("rank", RankTable), ("rank1", Rank1Table)):
        got, rounds, changed = gossip_frontier_packed(
            ctor(*map(jnp.asarray, out[key])), jnp.ones(t_loc, jnp.bool_), True, 64,
            interpret=True, fuse=1)
        assert int(changed) == 0
        out[f"{key}_frontier"], out[f"{key}_rounds"] = arrays(got), np.int64(rounds)
        out[f"{key}_reconcile"] = arrays(reconcile_packed_xla(ctor(*map(jnp.asarray, out[key]))))
    for m in (3, 8):
        t, res = Rank1Table(jnp.asarray(rank)), None
        for _ in range(m):
            t, res = gossip_round_ring_packed(t)
        out[f"rank1_window{m}"], out[f"rank1_window{m}_residual"] = arrays(t), np.int64(res)

    out["dense32"] = dense(32, 256)
    got, rounds, changed = gossip_until_converged_device(
        TableState(*map(jnp.asarray, out["dense32"])), jnp.asarray(topo.ring(32).neighbors),
        "ring", "reference", 64, use_pallas=False, lean=False)
    assert int(changed) == 0
    out["dense32_frontier"], out["dense32_rounds"] = arrays(got), np.int64(rounds)


def sim_cases(out: dict, expected: dict) -> None:
    """Every cell's op sequence on the reference's sim on four devices:
    after every op its return value, last_residual and table."""
    from bullet_tpu.models.netsim import PeerNetworkSim as JaxSim
    from bullet_tpu.ops import rank as jrk

    span = jrk.RANK_SPAN
    jrk.RANK_SPAN = worker.RANK_SPAN
    try:
        for name, layout, mode, topology, spmd, _fused in worker.CELLS:
            js = JaxSim(worker.P, capacity=worker.N, topology=topology, mode=mode,
                        layout=layout, mesh_devices=worker.SHARDS, use_shard_map=spmd,
                        use_pallas=True)
            record = {"route": js._convergence_strategy()[0], "ops": []}
            for k, (op, args) in enumerate(worker.ops_for(name)):
                result = worker.plain(getattr(js, op)(*args))
                for f, field in enumerate(js.table):
                    out[f"{name}/{k}/{f}"] = np.asarray(field)
                record["ops"].append({"result": result, "last_residual": js.last_residual,
                                      "fields": len(js.table)})
            if layout in ("rank", "rank1"):
                record["rank_epoch"] = js.rank_index.epoch
                out[f"{name}/rank_map"] = np.asarray(js.rank_index.rank_map())
            expected[name] = record
    finally:
        jrk.RANK_SPAN = span


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's side, then both workers once: (return codes,
    outputs, each process's verdicts)."""
    tmp = tmp_path_factory.mktemp("multihost")
    arrays, expected = {}, {}
    family_cases(arrays)
    sim_cases(arrays, expected)
    path = tmp / "cases.npz"
    np.savez(path, **arrays)
    (tmp / "cases.json").write_text(json.dumps(expected))
    rcs, outputs, _ = spawn(path, tmp)
    verdicts = []
    for rank in (0, 1):
        f = tmp / f"rank{rank}.json"
        verdicts.append(json.loads(f.read_text()) if f.exists() else {})
    return rcs, outputs, verdicts


def verdict(run, case):
    rcs, outputs, verdicts = run
    for rank, v in enumerate(verdicts):
        assert v.get(case) == "ok", (rank, v.get(case), v.get("error"), outputs[rank][-3000:])


def test_workers_end_cleanly(run):
    rcs, outputs, verdicts = run
    assert rcs == [0, 0], outputs
    for rank, v in enumerate(verdicts):
        assert "error" not in v and len(v) == 1 + len(FAMILIES) + len(worker.CELLS), (rank, v)


def test_host_info_and_a_second_initialize(run):
    """host_info's four keys, is_multihost, the global mesh's owners, and
    initialize_multihost called twice."""
    verdict(run, "host_info")


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_families_across_processes(run, family):
    verdict(run, family)


@pytest.mark.parametrize("cell", [c[0] for c in worker.CELLS])
def test_sim_op_sequence_across_processes(run, cell):
    verdict(run, f"sim {cell}")


def test_a_dead_process_fails_its_peer_within_the_timeout(tmp_path):
    """Rank 1 exits before the first collective; rank 0's must raise, not
    hang, within the group's timeout."""
    rcs, outputs, ended = spawn(tmp_path / "none.npz", tmp_path, mode="die",
                                timeout=worker.TIMEOUT_S + 60)
    assert rcs[1] == 3, outputs
    assert rcs[0] not in (0, None), outputs
    assert ended[0] is not None and ended[0] < worker.TIMEOUT_S + 30, ended


def test_a_stalled_process_fails_its_peer_at_the_timeout(tmp_path):
    """Rank 1 lives on but never reaches the collective (a process that
    took another branch); rank 0's must raise once the group's timeout
    passes, long before rank 1 ends."""
    rcs, outputs, ended = spawn(tmp_path / "none.npz", tmp_path, mode="stall",
                                timeout=8 * worker.STALL_TIMEOUT_S + 60)
    assert rcs[0] not in (0, None), outputs
    assert ended[1] is None, "the stalled process ended first"
    # it waited the timeout, then gave up
    assert worker.STALL_TIMEOUT_S - 1 < ended[0] < worker.STALL_TIMEOUT_S + 20, ended
    assert "timed out" in outputs[0].lower() or "timeout" in outputs[0].lower(), outputs[0][-2000:]


def test_the_package_import_starts_no_process_group():
    """Importing the port, its multihost module among them, initializes
    nothing: a mesh built here is a one-process mesh."""
    import bullet_tpu_torch  # noqa: F401
    from bullet_tpu_torch.parallel import multihost
    from bullet_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized() and not multihost.is_multihost()
    mesh = make_mesh(4, "cpu")
    assert mesh.owners == (0, 0, 0, 0) and mesh.local == (0, 1, 2, 3)
    assert not mesh.distributed
    assert multihost.host_info()["process_count"] == 1
