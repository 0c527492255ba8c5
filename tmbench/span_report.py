"""Where the host's time goes in a traced window: the program's spans
beside the device trace; not part of a benchmark run.

    python3 tmbench/span_report.py --workload mnist-sensors --seed 11 --seconds 51

Serves one cell as a ``--trace 1`` run does, then prints one JSON line:
the run's per-layer metrics, ``rows_per_s``, and ``spans.report`` (the
clocks' agreement, the steady slice's device idle under each kind of
span and under none, each kind's mean length and on-CPU share).  Needs
the card, like a run; the answers are not checked.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from tmbench import harness, spans

    if not torch.cuda.is_available():
        print("tmbench: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    bench, cell, config, traffic = harness.find_cell(ROOT, args.workload)
    run = harness.Run(config, traffic, args.seed, "cuda:0", True, t_start)
    run.setup()
    run.run_window(args.seconds)
    out = {
        "workload": args.workload, "seed": args.seed,
        "rows_per_s": harness.reader("end_to_end", "rows_per_s")(run),
        "metrics": {k: v["value"] for k, v in
                    harness.metric_values(bench, cell, run, "layer_metrics").items()},
        "spans": spans.report(run),
    }
    metrics = spans.program_metrics(run)
    if metrics is not None:
        out["spans_dropped"] = metrics.spans_dropped
        out["offsets_ns"] = metrics.span_offsets_ns[:1] + metrics.span_offsets_ns[-1:]
    run.close_program()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
