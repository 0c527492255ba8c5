"""Execution of the port, the port of ``repro.dist``: the paper's
multi-core compressed-TM executor on a mesh, the class-sharded TM train
step, and the LM step builders on one device.

Modules:
  sharding.py    the port's ``Mesh`` (``make_mesh``) and the batch-axis
                 rule (``batch_axes``)
  tm_sharded.py  class-parallel x batch-parallel compressed-TM executor
                 (the Fig-7 multi-core split), its tiles on the
                 hand-written ``clause_table`` kernel
  steps.py       make_tm_train_step, the class-sharded TM feedback step
                 the recal worker scales out with; the LM steps
                 (make_train_step, make_prefill_step, make_decode_step,
                 opt_config_for) on one device

One process drives every device of a mesh; there is no
``torch.distributed``.  The LM's parameter sharding rules and the
dry-run of the reference package are not here yet.
"""

from .sharding import Mesh, batch_axes, make_mesh
from .steps import (
    TMTrainStep,
    make_decode_step,
    make_prefill_step,
    make_tm_train_step,
    make_train_step,
    opt_config_for,
)
from .tm_sharded import (
    TM_CONFIGS,
    TMShardedConfig,
    build_tm_sharded,
    fill_clause_tables,
    operands_from_plan,
)

__all__ = [
    "Mesh",
    "TMShardedConfig",
    "TMTrainStep",
    "TM_CONFIGS",
    "batch_axes",
    "build_tm_sharded",
    "fill_clause_tables",
    "make_decode_step",
    "make_mesh",
    "make_prefill_step",
    "make_tm_train_step",
    "make_train_step",
    "operands_from_plan",
    "opt_config_for",
]
