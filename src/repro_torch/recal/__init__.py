"""Online recalibration: the paper's Fig-8 loop as a running subsystem,
the port of ``repro.recal``.

  monitor.py        DriftMonitor — windowed accuracy / class-sum-margin
                    statistics over served predictions; decides WHEN
  train_engine.py   TrainEngine plugin registry — HOW one update runs
                    ('reference' plain PyTorch, 'packed' the fused int8
                    ``tm_train`` kernel, 'sharded' the class-sharded
                    ``dist.steps`` step on a mesh; bit-identical to each
                    other and to the reference package)
  worker.py         RecalWorker — incremental fold-in-seeded fine-tuning
                    through a TrainEngine; produces the new TA state
  compressor.py     Compressor — an optional prune policy
                    (``repro_torch.prune``), include-stream encoding with
                    a bit-exact dense-oracle publication gate; produces
                    WHAT ships
  controller.py     RecalController — drain-then-swap publication through
                    the serving node, post-swap validation, auto-rollback

Training runs on the CUDA card unless ``device="cpu"`` is passed (or a
mesh on the CPU, ``mesh=dist.make_mesh(..., devices="cpu")``).
"""

from .compressor import CompressionReport, Compressor
from .controller import RecalController, RecalEvent
from .monitor import DriftDecision, DriftMonitor
from .train_engine import (
    TRAIN_ENGINES,
    PackedTrainEngine,
    ReferenceTrainEngine,
    ShardedTrainEngine,
    TrainEngine,
    TrainEngineBase,
    make_train_engine,
    register_train_engine,
    select_train_engine,
    train_engine_names,
)
from .worker import RecalWorker

__all__ = [
    "CompressionReport",
    "Compressor",
    "DriftDecision",
    "DriftMonitor",
    "PackedTrainEngine",
    "RecalController",
    "RecalEvent",
    "RecalWorker",
    "ReferenceTrainEngine",
    "ShardedTrainEngine",
    "TRAIN_ENGINES",
    "TrainEngine",
    "TrainEngineBase",
    "make_train_engine",
    "register_train_engine",
    "select_train_engine",
    "train_engine_names",
]
