"""The benchmark's command: one run of one cell.

    python3 -m canalbench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. It prints the result as the last line of
standard output (one JSON object) and the numbers compared with their
limits as the last lines of standard error. It exits non-zero and prints
no result when there is no CUDA card, or fewer than the cell asks for,
or when JAX or the JAX package was loaded in this process.

``--control depth`` runs the control that decides the limits (see
PERF.md); the benchmark's own runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
#: the program's build and kernel caches, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="canalbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run the control of the correctness limits")
    args = p.parse_args(argv)

    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(CHECKOUT / rel)
    sys.path.insert(0, str(CHECKOUT / "src"))

    import torch

    from canalbench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("canalbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"canalbench: {cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, cell, args.seed, args.seconds,
                           bool(args.trace), T_START,
                           control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"canalbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
