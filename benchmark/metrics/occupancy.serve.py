"""Mean decode rows an iteration over the slots, in %, over the
scheduler's iterations in the window (its ``StepLedger`` entries; the rows
each decode pass served, from the scheduler's trace)."""


def read(run):
    host = run.get("host")
    if not host or not host["iterations"]:
        return None
    rows = [r for r, _ in host["iterations"]]
    return 100.0 * sum(rows) / len(rows) / host["slots"]
