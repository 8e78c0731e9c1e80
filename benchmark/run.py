"""Run one cell of BENCHMARK.json once, on this machine's CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up and warm-up, then one caller's closed
loop for --seconds, then the plain reference judges a sample of the
answers. The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device; breakdown when traced; last, each
number compared beside its limit); the last lines of standard error are
those numbers again, after the card's name and power limit. --trace 0
reports the cell's end-to-end metrics, --trace 1 its per-layer metrics,
read over a traced stretch of the window.

`--control 1` runs the configuration's `control_solver` (the program's
lower-precision path) in the program's place: the output check's control,
which has to come out not correct. Measured runs never pass it.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip() or f"not read (exit {out.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import core, spec

    cell = spec.load_cell(ROOT, args.workload, os.path.basename(HERE))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = core.execute(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        control=bool(args.control), folder=os.path.basename(HERE), started=STARTED,
    )
    bad = core.forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
