"""Milliseconds of the scheduler's ``StepLedger`` decode segment an
iteration, over the window's iterations that decoded."""


def read(run):
    host = run.get("host")
    if not host:
        return None
    decode = [e["phases"]["decode"] for _, e in host["iterations"]
              if e["phases"]["decode"] > 0]
    return 1e3 * sum(decode) / len(decode) if decode else None
