"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 tmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  The
port's kernels build into ``build/kernels/`` inside the checkout on its
first run.  Exits
nonzero, printing no result, without a CUDA card, with fewer cards than
the cell asks for, without the port beside it, or when the run has
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"tmbench: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from tmbench import harness

    _, cell, _, _ = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("tmbench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"tmbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    harness.execute(ROOT, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda:0", t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
