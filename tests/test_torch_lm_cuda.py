"""The LM families (dense, MoE, VLM, XLSTM, Zamba2, Whisper) on a CUDA
card against the CPU, from the same fp32 numpy parameters (std 0.3):
``loss``, ``prefill`` (logits and every cache leaf) and a decode step
within 1e-3 (fp32; TF32 stays off, PyTorch's default), then
one bf16 train step with a finite loss and grad norm that changes the
parameters; and the expert-parallel MoE (``moe_ffn_ep``) on logical
meshes of the card against ``moe_ffn`` on each data shard's rows, fp32,
within 1e-5 of the largest output magnitude (not bit-equal: the
combine's float ``index_add`` uses atomics on CUDA).

Marked ``cuda``; every test skips itself without a card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_lm_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist.steps import make_train_step, opt_config_for
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten

pytestmark = pytest.mark.cuda

ARCHS = ["stablelm-3b-smoke", "starcoder2-7b-smoke", "moonshot-v1-16b-a3b-smoke",
         "internvl2-26b-smoke", "xlstm-125m-smoke", "zamba2-2.7b-smoke",
         "whisper-medium-smoke"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_on_the_card_matches_the_cpu(dev, arch):
    cfg = get(arch)
    fam = api.family_for(cfg)
    rng = np.random.default_rng(0)
    tree = unflatten((p, (rng.normal(size=s.shape) * 0.3).astype(np.float32))
                     for p, s in flatten(api.abstract_params(cfg)))
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, cfg.encoder_len, cfg.d_model)).astype(
            np.float32)
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        params = lm_params_from_numpy(cfg, tree, device=d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        loss = fam.loss(cfg, params, b).detach()
        logits, cache = fam.prefill(cfg, params, b)
        # copies: decode writes the cache in place
        leaves = [t.float().cpu().clone() for t in flatten_cache(cache)]
        logits2, _ = fam.decode(cfg, params, cache, {
            "token": torch.from_numpy(tok).to(d), "pos": 15})
        out[str(d)] = [loss.cpu(), logits.cpu(), *leaves, logits2.cpu()]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-3

    params = fam.init_params(cfg, 0, device=dev)
    before = {p: t.clone() for p, t in params.state_dict().items()}
    opt = opt_config_for(cfg)
    step = make_train_step(cfg, opt, device=dev)
    if cfg.family == "encdec":  # frames in the parameters' dtype (input_specs)
        batch["frames"] = torch.from_numpy(batch["frames"]).to(torch.bfloat16)
    params, _, m = step(params, adamw.init(opt, params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert any(not torch.equal(before[p], t) for p, t in params.state_dict().items())


def flatten_cache(cache):
    """A cache's tensors (dict keys sorted, tuples in order)."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in flatten_cache(cache[k])]
    if isinstance(cache, tuple):
        return [t for c in cache for t in flatten_cache(c)]
    return [cache]


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 2)])
def test_moe_ffn_ep_on_the_card_matches_moe_ffn(dev, shape):
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import moe

    cfg = get("moonshot-v1-16b-a3b-smoke")
    rng = np.random.default_rng(1)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(D, E)),
         "w_gate": rng.normal(size=(E, D, F)) * 0.05,
         "w_up": rng.normal(size=(E, D, F)) * 0.05,
         "w_down": rng.normal(size=(E, F, D)) * 0.05}
    p = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(4, 32, D)).astype(np.float32)).to(dev)
    mesh = make_mesh(shape, devices=dev)
    y = moe.moe_ffn_ep(p, x, cfg, mesh)
    rows = 4 // shape[0]
    want = torch.cat([moe.moe_ffn(p, x[i * rows:(i + 1) * rows], cfg)
                      for i in range(shape[0])])
    assert y.device == x.device and torch.isfinite(y).all()
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
