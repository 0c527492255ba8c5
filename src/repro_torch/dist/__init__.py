"""Execution of the port, the port of ``repro.dist``: the paper's
multi-core compressed-TM executor on a mesh, the class-sharded TM train
step, the LM's sharding rules and the LM step builders.

Modules:
  sharding.py    the port's ``Mesh`` (``make_mesh``: a logical mesh one
                 process drives, or a rank mesh of one process per
                 device), the batch-axis rule (``batch_axes``), the LM's
                 sharding rules (``param_shardings``, ``opt_shardings``,
                 ``input_shardings``, ``cache_shardings``, ``hint``) as
                 ``PartitionSpec`` data, the activation mesh, and
                 ``place`` (a tensor whole on a logical mesh's one
                 device; a rank's ``DTensor`` block on a rank mesh)
  collectives.py the LM's collectives on a rank mesh over
                 ``torch.distributed`` (per-axis all-gather,
                 reduce-scatter, all-reduce with a byte log; a rank's
                 parameter block gathered where it is used; the MoE's
                 ``model`` region)
  tm_sharded.py  class-parallel x batch-parallel compressed-TM executor
                 (the Fig-7 multi-core split), its tiles on the
                 hand-written ``clause_table`` kernel
  steps.py       make_tm_train_step, the class-sharded TM feedback step
                 the recal worker scales out with; the LM steps
                 (make_train_step, make_prefill_step, make_decode_step,
                 opt_config_for) on one device, and the train,
                 prefill and decode steps of one rank of a rank mesh

The TM paths run on logical meshes (one process drives every device);
the LM train, prefill and decode steps also run on a rank mesh under
``torch.distributed``.  ``tm_sharded.dryrun_tm`` is the TM path of the
dry run (``launch.dryrun --include-tm``).
"""

from .sharding import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    activation_mesh,
    batch_axes,
    cache_shardings,
    hint,
    hint_spec,
    input_shardings,
    make_mesh,
    mesh_device,
    opt_shardings,
    param_shardings,
    place,
    replicated,
    set_activation_mesh,
)
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
    dryrun_tm,
    fill_clause_tables,
    operands_from_plan,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "TMShardedConfig",
    "TMTrainStep",
    "TM_CONFIGS",
    "activation_mesh",
    "batch_axes",
    "build_tm_sharded",
    "cache_shardings",
    "dryrun_tm",
    "fill_clause_tables",
    "hint",
    "hint_spec",
    "input_shardings",
    "make_decode_step",
    "make_mesh",
    "make_prefill_step",
    "make_tm_train_step",
    "make_train_step",
    "mesh_device",
    "operands_from_plan",
    "opt_config_for",
    "opt_shardings",
    "param_shardings",
    "place",
    "replicated",
    "set_activation_mesh",
]
