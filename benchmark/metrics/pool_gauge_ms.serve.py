"""Milliseconds of the KV pool's gauge upkeep an iteration: the
scheduler's ``StepLedger`` entry's ``detail.pool_gauge_s`` (every
``KvBlockPool`` gauge update of the iteration, in whichever segment it
fell), over the window's iterations that decoded. Nothing where the
entries carry no ``detail``."""


def read(run):
    host = run.get("host")
    if not host:
        return None
    gauge = [e["detail"]["pool_gauge_s"] for _, e in host["iterations"]
             if e["phases"]["decode"] > 0
             and "pool_gauge_s" in e.get("detail", {})]
    return 1e3 * sum(gauge) / len(gauge) if gauge else None
