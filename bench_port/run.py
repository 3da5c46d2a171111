"""One run of one cell of the port's benchmark, from the root of a checkout:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (see ``harness.py``).
Exits non-zero, with no result, where there is no CUDA card or fewer cards
than the cell asks for, where the port (``src/repro_torch``) is missing, or
where JAX or the JAX package was loaded. The kernels' build directory is
``bench_port/.build`` inside the checkout, so only a cell's first run in a
checkout builds them. Torch's host operations run on one thread: the run
is one process that drives the card, and worker threads of its own only
make its host time less steady.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(CHECKOUT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    build = HERE / ".build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(CHECKOUT / "src"))
    sys.path.insert(0, str(CHECKOUT))
    from bench_port import harness

    return harness.run(manifest, args.workload, args.seed, args.seconds,
                       bool(args.trace), base=CHECKOUT, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
