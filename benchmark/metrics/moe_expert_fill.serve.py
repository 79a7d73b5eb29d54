"""The share of the MoE experts' rows that real tokens fill, in %: the
tokens the executor's forwards held (a chunk's valid ones, not its
padding; a decode pass's active slots, not its idle ones) over the rows
the expert products computed (experts x batch rows x capacity a forward),
summed over MoE layers and the window's iterations (the ``StepLedger``
entries' ``detail``). Nothing where no expert row was computed."""


def read(run):
    host = run.get("host")
    if not host:
        return None
    details = [e["detail"] for _, e in host["iterations"]
               if "moe_expert_rows" in e.get("detail", {})]
    rows = sum(d["moe_expert_rows"] for d in details)
    if rows <= 0:
        return None
    return 100.0 * sum(d["moe_routed_tokens"] for d in details) / rows
