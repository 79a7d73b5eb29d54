"""The serving step's share of the card's bf16 peak, in %: the model
FLOPs of the useful work the executor's calls did in the window (the
block's frozen ``serve_flops``: for GPT-2, prompt tokens prefilled,
tokens decoded for live requests, the logits of the tokens picked, the
causal attention pairs), over the window's seconds times the peak."""


def read(run):
    host, peak = run.get("host"), run.get("peak")
    if not host or not peak:
        return None
    w = host["work"]
    if not (w["prefill_tokens"] or w["decode_tokens"]):
        return None
    flops = run["block"].serve_flops(run["model"], w)
    return 100.0 * flops / (host["seconds"] * peak["bfloat16"])
