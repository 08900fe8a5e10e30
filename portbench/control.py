"""The control of a cell's comparison, run on the card at the cell's size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--calls n]

For each seed it makes the cell's inputs and puts the plain reference,
computed at the precision below the one the configuration states (the HV
bundled and held in int8 instead of int16), where ``calls`` timed calls
would have put the program's outputs; the entry's own ``check`` then
judges them against the reference at the stated precision, as it judges a
run. Prints one JSON line a seed with the compared numbers and their
limits; a sound control fails them. The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path.cwd()
STATED_BITS, CONTROL_BITS = 16, 8


def control(config: dict, mix: dict, seed: int, device, tmp: Path,
            calls: int) -> dict:
    """{name: (number, limit)} of a run's comparison, the control in the
    program's place for ``calls`` calls."""
    from portbench.harness import entry, spec

    e = spec.entry(mix["entry"])(config, mix, seed, [device], tmp,
                                 entry.Spans())
    e.inputs()
    want = e.reference(hv_bits=STATED_BITS)
    e.stand_in(e.reference(hv_bits=CONTROL_BITS), calls)
    return e.check(want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import entry, spec

    s = spec.Spec(ROOT)
    cell = s.cell(args.workload)
    config, mix = s.config(cell["config"]), s.traffic(cell["traffic"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
            checks = control(config, mix, seed, device, Path(tmp), args.calls)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "calls": args.calls,
            "correct": entry.passes(checks),
            "seconds": time.monotonic() - t,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
