"""Milliseconds of the host issuing the decode forward an iteration: the
scheduler's ``StepLedger`` decode segment less the executor's blocking
transfers in it (``detail.decode_wait_s``: the copies of the pass's
tokens and positions, which drain the stream first, and the read of its
argmaxes), over the window's iterations that decoded.
``decode_iter_ms.serve`` less this is the host's wait on the card, which
holds whatever device work was queued before the pass. Nothing where the
entries carry no executor counters."""


def read(run):
    host = run.get("host")
    if not host:
        return None
    launch = [e["phases"]["decode"] - e["detail"]["decode_wait_s"]
              for _, e in host["iterations"]
              if e["phases"]["decode"] > 0
              and "decode_wait_s" in e.get("detail", {})]
    return 1e3 * sum(launch) / len(launch) if launch else None
