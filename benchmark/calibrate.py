"""Readings that a serving cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 12 --out <file>

For each seed, one run of the cell in this process (its window of
``--seconds``) and the comparison numbers of its sample; for each control
seed, the control's numbers over the same sample. It writes the readings
as JSON. The benchmark's own runs do not run any of this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import control, manifest, serve_cell  # noqa: E402
from harness.cli import forbidden_loaded  # noqa: E402


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def readings(args, device) -> dict:
    mf = manifest.load_manifest()
    cell = manifest.find_cell(mf, args.workload)
    config = manifest.load_config(mf, cell["config"])
    traffic = manifest.load_traffic(cell["traffic"])
    limits = manifest.load_limits(args.workload)
    out = {"program": {}, "control": {}}
    for seed in args.seeds:
        r = serve_cell.run(config, traffic, seed, args.seconds, False,
                           device, time.monotonic(), limits)
        out["program"][seed] = {"numbers": r["numbers"], "e2e": r["e2e"],
                                "sample": r["sample"], "fill": r["fill"],
                                "host_load": r["host_load"],
                                "setup_s": r["setup_s"],
                                "memory_peak_bytes": r["memory_peak_bytes"]}
        if seed in args.control_seeds:
            out["control"][seed] = control.serve_control_numbers(
                config, traffic, seed, r["sequences"], device)
        print(seed, out["program"][seed], out["control"].get(seed),
              flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = {"device": torch.cuda.get_device_name(device),
              "args": vars(args), "result": readings(args, device),
              "forbidden_modules": forbidden_loaded()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
