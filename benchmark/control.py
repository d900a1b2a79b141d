"""The control of a cell's comparison: the plain reference in the
precision just below the one the configuration states (TF32 for float32
with TF32 off), put in the program's place and judged as the program's
images are.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it builds the cell's scene, takes the camera path's first
``frames`` poses (the cell's check sample size), renders the sampled pixels
with the control and prints the numbers compared, one JSON line a seed.
It runs the reference twice over each sample (control and judge), so it
takes about twice a run's comparison.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(spec, name, seed, device):
    import numpy as np

    from benchmark import harness
    from benchmark.traffic import CameraPath

    cell = harness.Cell.load(spec, name)
    scene = harness.load_module(cell.root, "scenes", cell.config["scene"]).build(
        seed, **cell.config.get("args", {}))
    rng_path, rng_check = (np.random.default_rng(s)
                           for s in np.random.SeedSequence(seed).spawn(2))
    path = CameraPath(scene["camera"], cell.traffic["camera"], rng_path)
    kept = [(path.pose(i), None) for i in range(int(cell.check["frames"]))]
    render = harness.control_renderer(scene, cell, device)
    return harness.compare(kept, scene, cell, rng_check, device, render=render)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of a cell's comparison")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(spec, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
