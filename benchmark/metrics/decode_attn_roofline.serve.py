"""The decode attention kernels' share of their roofline, in %: the least
time of the traced iterations' decode attention (the block's frozen
``decode_attention_least_s``: each live request's row at its position,
the K and V of the keys it admits read once; an idle slot that the
executor decodes beside them is no work a request needs) over the device
time of the kernels of the family ``kernels/decode_attention`` in the
traced slice."""

from harness.manifest import in_family, kernel_patterns


def read(run):
    sl, peak = run.get("slice"), run.get("peak")
    if not sl or not peak or not sl["decode_positions"]:
        return None
    family = kernel_patterns("decode_attention")
    seconds = sum(s for name, s in sl["kernels"].items()
                  if in_family(name, family))
    if seconds <= 0:
        return None
    least = sum(run["block"].decode_attention_least_s(run["model"], pos,
                                                      peak)
                for pos in sl["decode_positions"])
    return 100.0 * least / seconds
