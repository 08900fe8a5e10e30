"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up makes the cell's inputs from the seed
and warms up; the window then runs the cell's calls back to back for the
given seconds (with ``--trace 1`` under ``torch.profiler``); after it, what
the timed calls produced is compared with the plain reference. The last
lines of standard error give each compared number beside its limit; the
last line of standard output is the result as one JSON object. A run
without the cards the cell asks for, or that finds JAX or the JAX package
loaded, exits with another code than 0 and prints no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "_cache" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from portbench.harness import guard, runner, spec

    try:
        s = spec.Spec(ROOT)
        cell = s.cell(args.workload)
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    result = runner.run_cell(s, cell, args.seed, args.seconds, bool(args.trace),
                             devices, T0)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"portbench: check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
