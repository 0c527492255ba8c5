"""Uniform model-family API, the port of ``repro.models.api``.

Every family exposes:
  param_specs(cfg)            parameter tree on the ``meta`` device
  init_params(cfg, generator, device=None)   real params (an ``LMParams``)
  loss(cfg, params, batch)    scalar training loss
  prefill(cfg, params, batch) (logits, cache)
  decode(cfg, params, cache, batch) (logits, cache)
  input_specs(cfg, shape)     batch tree on ``meta``
  cache_specs(cfg, shape)     cache tree on ``meta`` (decode)

The ``dense``, ``moe`` and ``vlm`` families share the dense trunk;
``ssm_xlstm`` is ``recurrent_lm.XLSTM``, ``hybrid`` ``recurrent_lm.Zamba2``
and ``encdec`` ``encdec.Whisper``.
"""

from __future__ import annotations

import math

from ..configs.base import ArchConfig
from ..tree import leaves
from . import dense
from .encdec import Whisper
from .recurrent_lm import XLSTM, Zamba2


class _DenseFamily:
    param_specs = staticmethod(dense.param_specs)
    init_params = staticmethod(dense.init_params)
    loss = staticmethod(dense.loss)
    prefill = staticmethod(dense.prefill)
    decode = staticmethod(dense.decode)
    input_specs = staticmethod(dense.input_specs)
    cache_specs = staticmethod(dense.cache_specs)


_FAMILIES = {
    "dense": _DenseFamily,
    "moe": _DenseFamily,  # same trunk, MoE FFN switched by cfg.is_moe
    "vlm": _DenseFamily,  # early-fusion patches handled by cfg.family
    "ssm_xlstm": XLSTM,
    "hybrid": Zamba2,
    "encdec": Whisper,
}


def family_for(cfg: ArchConfig):
    return _FAMILIES[cfg.family]


def abstract_params(cfg: ArchConfig):
    return family_for(cfg).param_specs(cfg)


def count_params(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for s in leaves(abstract_params(cfg)))


def active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: routed top-k of the experts)."""
    if not cfg.is_moe:
        return count_params(cfg)
    total = count_params(cfg)
    expert_p = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
    active_expert_p = 3 * cfg.d_model * cfg.d_ff * cfg.top_k * cfg.n_layers
    return total - expert_p + active_expert_p
