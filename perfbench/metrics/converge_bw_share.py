"""converge_bw_share: the bytes floor of the window's batches (every
replica's entry of every leaf a batch wrote, stored once:
``yardstick.converge_floor_bytes``, from the generated ops alone) over what
the card's peak bandwidth moves in the device's busy time inside the
converge spans, in %. It reads how far the converge is from the least
traffic any implementation needs, not how well a kernel streams. On a mesh
(the configuration's ``shards``, 1 by default) the floor is that of the
traced card's replicas, ``num_peers / shards`` rows."""

from perfbench.yardstick import PEAK_BYTES_PER_S, converge_floor_bytes


def read(run):
    busy = run.busy()
    peak = PEAK_BYTES_PER_S.get(run.device_kind)
    if busy is None or peak is None or not run.batches:
        return None
    dev_s = sum(busy.covered(*b.span_ns) for b in run.batches) / 1e9
    if dev_s <= 0:
        return None
    floor = sum(
        converge_floor_bytes(run.config["num_peers"] // run.config.get("shards", 1),
                             b.distinct_leaves, run.config["entry_bytes"])
        for b in run.batches)
    return 100.0 * floor / (peak * dev_s)
