"""Milliseconds of the scheduler's ``StepLedger`` "cow" segment an
iteration: after each decode pass, each token's copy-on-write check and
KV-pool write accounting (``KvBlockPool.set_used_tokens``), its stream
and its counters, over the window's iterations that decoded."""


def read(run):
    host = run.get("host")
    if not host:
        return None
    cow = [e["phases"]["cow"] for _, e in host["iterations"]
           if e["phases"]["decode"] > 0]
    return 1e3 * sum(cow) / len(cow) if cow else None
