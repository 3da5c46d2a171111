"""The control of a cell's comparison: the reference put in the program's
place and computed one precision below the configuration's (bfloat16 for
its float32 ALU), read on seeds at the cell's own size. It needs no card:

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13

For each seed it prints the numbers the run's comparison would read: the
node values that differ from the float32 reference (the cycles and counters
do not depend on the values, so the reference's own are what a run of the
control returns), beside the same count for the float32 reference against
itself. A control that passes the comparison would show that it cannot
tell a lower precision from the configuration's.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def readings(config: dict, seeds, dtype_name: str = "bfloat16") -> list:
    """[(seed, values the control gets wrong, values the reference itself
    gets wrong, nodes)] for ``config``'s graph."""
    import numpy as np
    import torch

    from bench_port import arrow_lu, overlay_ref

    gen = config["graph"]
    struct = arrow_lu.structure(gen["blocks"], gen["block_size"],
                                gen["border"])
    prep = overlay_ref.prepare(struct)
    dtype = getattr(torch, dtype_name)
    out = []
    for seed in seeds:
        values = arrow_lu.input_values(struct, seed)
        ref = overlay_ref.evaluate(struct, prep, values)
        low = overlay_ref.evaluate(struct, prep, values, dtype=dtype)
        again = overlay_ref.evaluate(struct, prep, values)
        out.append((seed, int(np.count_nonzero(~(low == ref))),
                    int(np.count_nonzero(~(again == ref))), ref.size))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    manifest = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((CHECKOUT / entry["file"]).read_text())
    for seed, low, again, n in readings(config, args.seeds):
        print(f"control {args.workload} seed {seed}: values_wrong "
              f"{low} of {n} in bfloat16 (limit 0); float32 reference "
              f"against itself {again}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
