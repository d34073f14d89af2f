"""The control of a cell's comparison, read on the chip.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` as a run makes them, then two readings of each number the
run compares: the program's (what its window produced, against the
float64 reference) and the control's (the reference computed in bfloat16,
put in the program's place, against the float64 reference).  One JSON
line per seed.  A limit lies above every program reading and below every
control reading (PERF.md gives them).  The benchmark's runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(driver, dtype):
    """The program's and the control's reading of the cell's number."""
    from portbench.drivers import _replay
    refs = list(driver.reference())
    program = _replay.compare(driver.cell, zip(driver.answers(), refs))
    control = _replay.compare(driver.cell, zip(driver.reference(dtype),
                                               refs))
    return {"program": program["compared"], "control": control["compared"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.make_cell(args.workload, seed, args.seconds, False)
        driver = harness.load_module("drivers",
                                     cell.traffic["driver"]).Driver(cell)
        driver.setup()
        driver.window()
        driver.release()
        line = {"workload": args.workload, "seed": seed,
                **readings(driver, torch.bfloat16),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
