"""The card's idle share of the traced slice of a serving window, in %:
1 - (the union of device intervals) / (the slice's length)."""


def read(run):
    sl = run.get("slice")
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
