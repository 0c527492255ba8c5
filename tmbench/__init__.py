"""tmbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One run serves one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) through ``repro_torch.accel.Accelerator`` with its
scheduler loop running, for a fixed window, and prints one JSON line:

    python3 tmbench/run.py --workload mnist-bulk --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

  configs/<config>.json        sizes of a Tsetlin Machine and its data
  traffic/<traffic>.json       parameters of the closed-loop clients
  end_to_end/<metric>.py       ``read(run)`` for an end-to-end metric
  layer_metrics/<metric>.py    ``read(run)`` for a per-layer metric

The yardstick lives here and imports nothing of the program: the data
generator and the class-sum reference (``reference/``), the work count
and the card's peaks (``work.py``), the trace reduction (``trace.py``)
and the comparison that decides ``correct`` (``check.py``).
"""
