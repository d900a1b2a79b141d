"""Run one cell of the benchmark of ``directx_raytracer_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The cell is
an entry of ``workloads`` in the root's ``BENCHMARK.json``; see
``benchmark/harness.py`` for what a run does and ``benchmark/README.md`` for
the files a cell is made of.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.

Without a CUDA device, or without the program, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 1) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    age = harness.process_age_s()
    t_start = time.perf_counter() - age if age is not None else T_IMPORT
    harness.stage(f"python and torch loaded at {time.perf_counter() - t_start:.3f} s")
    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    try:
        import directx_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is missing: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < int(entry["chips"]):
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                    f"for {entry['chips']}")
    try:
        out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda", t_start=t_start)
    except harness.ForbiddenImport as e:
        return fail(str(e), 3)
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
