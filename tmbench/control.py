"""Readings that set and test the limits of ``correct``; not part of a
benchmark run.

    python3 tmbench/control.py --workload mnist-bulk --seconds 5 \
        --seeds 11 12 13 ... --controls 3

For each seed a short window at the cell's own load is served and
checked as a run checks it, every answer kept (the program's reading;
five seconds of bulk traffic compare more rows than a whole run keeps).  For the first
``--controls`` seeds, the answers of the same requests are then replaced
by a control and checked again, and the window is served once more with
each fault planted in the engine:

  controls   int16, int8: the reference's sums accumulated in a narrower
             integer (a precision step below the stated int32), clause
             weights cast to it;
             tie_high: the reference with the prediction's stated tie rule
             broken (the last class of largest sum);
             weights_ignored (weighted configurations only): the
             reference with every clause weight read as 1
  faults     answer_altered: one class sum of each engine batch off by 1;
             half_batch_left_out: the second half of each engine batch
             answered with zero sums

One JSON line per reading.  Needs the card, like a run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def tie_high(sums: np.ndarray) -> np.ndarray:
    """The last class of largest sum in each row."""
    return (sums.shape[1] - 1 - np.argmax(sums[:, ::-1], axis=1)).astype(np.int32)


def answer_altered(sums):
    sums[0, 0] += 1
    return sums


def half_batch_left_out(sums):
    sums[sums.shape[0] // 2:] = 0
    return sums


FAULTS = {"answer_altered": answer_altered, "half_batch_left_out": half_batch_left_out}


def plant(run, fault) -> None:
    """Break the served path under the scheduler: every engine call's
    sums pass through ``fault`` before the scheduler sees them."""
    engine = run.acc.engine
    call = engine.class_sums

    def broken(prog, x):
        return fault(np.array(call(prog, x)))

    engine.class_sums = broken


def control_answers(answers, sums_of, preds_of):
    """The requests' answers as a control gives them."""
    return [(off, n, sums_of[off:off + n], preds_of[off:off + n])
            for off, n, _, _ in answers]


def readings(root, workload, seed, seconds, device, controls):
    """[(variant, compare() result)] of one seed."""
    import torch

    from tmbench import check, harness
    from tmbench.reference.classsums import class_sums, predictions

    _, _, config, traffic = harness.find_cell(Path(root), workload)
    traffic = {**traffic, "check_share": 1.0}

    def served(fault=None):
        run = harness.Run(config, traffic, seed, device)
        run.setup()
        if fault is not None:
            plant(run, fault)
        run.run_window(seconds)
        run.close_program()
        return run

    run = served()
    ref_sums, ref_preds = run.reference()
    got, lost = run.answers()
    out = [("program", check.compare(got, lost, ref_sums, ref_preds))]
    if not controls:
        return out
    x = torch.from_numpy(run.pool).to(run.device)
    actions = run.actions.to(run.device)
    variants = [("int16", torch.int16, run.weights), ("int8", torch.int8, run.weights)]
    if run.weights is not None:
        variants.append(("weights_ignored", torch.int32, None))
    for name, dtype, weights in variants:
        sums = class_sums(actions, x, dtype=dtype, weights=weights).cpu().numpy()
        answers = control_answers(got, sums, predictions(sums))
        out.append((name, check.compare(answers, lost, ref_sums, ref_preds)))
    answers = control_answers(got, ref_sums, tie_high(ref_sums))
    out.append(("tie_high", check.compare(answers, lost, ref_sums, ref_preds)))
    for name, fault in FAULTS.items():
        frun = served(fault)
        fgot, flost = frun.answers()
        out.append((name, check.compare(fgot, flost, *frun.reference())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    for i, seed in enumerate(args.seeds):
        for variant, res in readings(ROOT, args.workload, seed, args.seconds,
                                     "cuda:0", i < args.controls):
            line = {"workload": args.workload, "seed": seed, "variant": variant,
                    "correct": res["correct"], "rows_checked": res["rows_checked"],
                    **{k: v["value"] for k, v in res["checks"].items()}}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
