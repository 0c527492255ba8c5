"""The LM on a mesh, launch and elasticity: the port's
``checkpoint.manager`` on LM train states, ``launch.train``,
``launch.serve.Server`` with a mesh, ``launch.mesh``,
``data.pipeline.shard_batch`` and ``runtime_ft.elastic`` against the
reference.

Tolerances: checkpoint manifests (names, shapes, dtypes) equal; restored
leaves exact in both directions; train-step loss and grad norm within
1e-4 relative per step (fp32 parameters of std 0.3 from numpy); resume
and reshard exact (``==`` and ``torch.equal``); greedy tokens equal.

The reference's ``launch.train``/``launch.serve`` raise on this jax under
``jax.make_mesh``'s Explicit axes, so its ``build`` and ``Server`` run
under a mesh of ``AxisType.Auto`` axes; its expert-parallel MoE raises
under any mesh (``check_rep``), so its MoE side runs with no mesh.  A
reference bf16 leaf is saved as ``V2`` words that the reference's own
``restore`` refuses; the cross-package restores are checked on fp32
states, and the port's read of bf16 leaves on their own.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.configs.registry import get as rget
from repro.dist import sharding as rshd
from repro.dist import steps as rsteps
from repro.launch import train as rtrain
from repro.launch.serve import Server as RServer
from repro.models.api import family_for as r_family_for
from repro.optim import adamw as radamw
from repro.runtime_ft import elastic as relastic
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig, shard_batch
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import make_train_step, opt_config_for
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train
from repro_torch.launch.serve import Server
from repro_torch.models import api, moe
from repro_torch.models.common import LMParams
from repro_torch.optim import adamw
from repro_torch.runtime_ft import elastic
from repro_torch.tree import as_tree, flatten, unflatten

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILY_ARCHS = ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke", "internvl2-26b-smoke",
                "xlstm-125m-smoke", "zamba2-2.7b-smoke", "whisper-medium-smoke"]


@pytest.fixture(autouse=True)
def no_activation_mesh():
    """``build`` and ``Server`` install process-global activation meshes
    in both packages: clear them after every test."""
    shd.set_activation_mesh(None)
    yield
    shd.set_activation_mesh(None)
    rshd.set_activation_mesh(None)


def _auto_mesh(shape=(1, 1)):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def np_params(cfg, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(api.abstract_params(cfg)))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _manifest(path, step):
    return json.loads((Path(path) / f"step_{step}" / "manifest.json").read_text())


# ---------------------------------------------------------------------------
# checkpoints of LM train states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_state_manifest_equals_the_reference(tmp_path, arch):
    """An ``LMParams`` is walked as the reference walks its param dict."""
    cfg, rcfg = get(arch), rget(arch)
    rp = r_family_for(rcfg).init_params(rcfg, jax.random.key(0))
    RManager(tmp_path / "ref").save(1, {
        "params": rp, "opt": radamw.init(rsteps.opt_config_for(rcfg), rp), "data": 0})
    params = api.family_for(cfg).init_params(cfg, 0, device="cpu")
    CheckpointManager(tmp_path / "port").save(1, {
        "params": params, "opt": adamw.init(opt_config_for(cfg), params), "data": 0})
    want, got = _manifest(tmp_path / "ref", 1), _manifest(tmp_path / "port", 1)
    assert got == want
    assert got["leaves"][-1]["name"].startswith("params/")
    assert any(leaf["dtype"] == "bfloat16" for leaf in got["leaves"])


def _random_state(cfg, seed):
    """A reference-shaped fp32 train state as numpy: params, moments, step
    and data position."""
    rng = np.random.default_rng(seed)
    tree = np_params(cfg, seed)
    m = {p: rng.normal(size=a.shape).astype(np.float32) for p, a in flatten(tree)}
    v = {p: rng.random(size=a.shape).astype(np.float32) for p, a in flatten(tree)}
    return tree, unflatten(m.items()), unflatten(v.items())


def _port_state(cfg, tree, m, v, step, data):
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    opt = adamw.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                           m=as_tree(lm_params_from_numpy(cfg, m, device="cpu")),
                           v=as_tree(lm_params_from_numpy(cfg, v, device="cpu")))
    return {"params": params, "opt": opt, "data": data}


@pytest.mark.parametrize("arch", ["stablelm-3b-smoke", "xlstm-125m-smoke",
                                  "moonshot-v1-16b-a3b-smoke"])
def test_train_state_restores_across_packages_exactly(tmp_path, arch):
    cfg, rcfg = get(arch), rget(arch)
    tree, m, v = _random_state(cfg, 3)
    ref_state = {"params": jax.tree.map(jnp.asarray, tree),
                 "opt": radamw.AdamWState(step=jnp.int32(7),
                                          m=jax.tree.map(jnp.asarray, m),
                                          v=jax.tree.map(jnp.asarray, v)),
                 "data": 5}
    RManager(tmp_path / "ref").save(7, ref_state)
    like = _port_state(cfg, *_random_state(cfg, 4), 0, 0)
    got = CheckpointManager(tmp_path / "ref").restore(7, like=like)
    assert isinstance(got["params"], LMParams) and got["params"].cfg is cfg
    assert int(got["opt"].step) == 7 and int(got["data"]) == 5
    for want, have in ((tree, as_tree(got["params"])), (m, got["opt"].m),
                       (v, got["opt"].v)):
        for (p, a), (q, t) in zip(flatten(want), flatten(have)):
            assert p == q and t.dtype == torch.float32
            assert np.array_equal(t.detach().numpy(), a), p
    # the port's save restores in the reference, every leaf exact
    CheckpointManager(tmp_path / "port").save(7, got)
    back = RManager(tmp_path / "port").restore(7, like=ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaves_round_trip_and_read_the_reference_words(tmp_path):
    """bf16 leaves are saved as the reference saves them (``V2`` words);
    the port reads them back exactly, the reference's ``restore`` cannot."""
    cfg, rcfg = get("stablelm-3b-smoke"), rget("stablelm-3b-smoke")
    rp = r_family_for(rcfg).init_params(rcfg, jax.random.key(1))
    RManager(tmp_path).save(1, {"params": rp})
    like = {"params": api.family_for(cfg).init_params(cfg, 0, device="cpu")}
    got = CheckpointManager(tmp_path).restore(1, like=like)
    for (p, a), (q, t) in zip(flatten(jax.tree.map(np.asarray, rp)),
                              flatten(as_tree(got["params"]))):
        assert p == q and t.dtype == torch.bfloat16
        assert np.array_equal(t.detach().float().numpy(), a.astype(np.float32)), p
    with pytest.raises(TypeError, match="V2"):
        RManager(tmp_path).restore(1, like={"params": rp})
    CheckpointManager(tmp_path / "port").save(2, got)
    again = CheckpointManager(tmp_path / "port").restore(2, like=like)
    for (_, a), (_, b) in zip(flatten(as_tree(got["params"])),
                              flatten(as_tree(again["params"]))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not survive the cast"):
        CheckpointManager(tmp_path / "port").save(3, {"w": torch.tensor([1 + 2 ** -10])})
        CheckpointManager(tmp_path / "port").restore(
            3, like={"w": torch.zeros(1, dtype=torch.bfloat16)})


def test_restore_places_by_shardings(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, {"w": torch.arange(8.0).reshape(2, 4), "n": 3})
    mesh = shd.make_mesh((2, 2), devices="cpu")
    sh = {"w": shd.NamedSharding(mesh, shd.P("data", "model")), "n": shd.replicated(mesh)}
    out = ckpt.restore(1, like={"w": torch.zeros(2, 4), "n": 0}, shardings=sh)
    assert torch.equal(out["w"], torch.arange(8.0).reshape(2, 4)) and int(out["n"]) == 3
    with pytest.raises(ValueError, match="1 leaves for 2"):
        ckpt.restore(1, like={"w": torch.zeros(2, 4), "n": 0}, shardings={"w": sh["w"]})
    two = np.empty(2, dtype=object)
    two[:] = [torch.device("cpu"), torch.device("meta")]
    split = shd.Mesh(two.reshape(1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="leaf 'w'"):
        ckpt.restore(1, like={"w": torch.zeros(2, 4), "n": 0}, shardings={
            "w": shd.NamedSharding(split, shd.P(None, "model")), "n": sh["n"]})


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def test_build_matches_the_reference_build_over_three_steps():
    cfg, rcfg = get("stablelm-3b-smoke"), rget("stablelm-3b-smoke")
    tree = np_params(cfg, 8)
    jitted, r_psh, r_osh, r_insh, r_opt, _ = rtrain.build(rcfg, _auto_mesh(), seq=32,
                                                          batch=4)
    rp = jax.device_put(jax.tree.map(jnp.asarray, tree), r_psh)
    r_state = jax.device_put(radamw.init(r_opt, rp), r_osh)
    mesh = shd.make_mesh((1, 1), devices="cpu")
    step, p_sh, o_sh, in_sh, opt_cfg, shape = train.build(cfg, mesh, seq=32, batch=4)
    assert shd.activation_mesh() is mesh
    assert (shape.seq_len, shape.global_batch, shape.kind) == (32, 4, "train")
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    state = adamw.init(opt_cfg, params)
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 32, 4))
    for _ in range(3):
        batch = stream.next_batch()
        rp, r_state, m_r = jitted(rp, r_state, jax.tree.map(
            lambda x, s: jax.device_put(x, s), batch, r_insh))
        params, state, m_t = step(params, state, shard_batch(batch, mesh, in_sh))
        for k in ("loss", "grad_norm"):
            assert _rel(float(m_t[k]), float(m_r[k])) <= 1e-4, k


def test_moe_train_on_a_model_split_mesh_matches_the_reference():
    """moonshot's smoke arch trains through ``moe_ffn_ep`` on (1, 2); the
    reference trains with no mesh (its EP path raises here)."""
    cfg, rcfg = get("moonshot-v1-16b-a3b-smoke"), rget("moonshot-v1-16b-a3b-smoke")
    tree = np_params(cfg, 9)
    mb = rcfg.train_microbatches
    r_opt = rsteps.opt_config_for(rcfg)
    r_step = jax.jit(rsteps.make_train_step(rcfg, r_opt, microbatches=mb))
    rp = jax.tree.map(jnp.asarray, tree)
    r_state = radamw.init(r_opt, rp)
    mesh = shd.make_mesh((1, 2), devices="cpu")
    step, _, _, in_sh, opt_cfg, _ = train.build(cfg, mesh, seq=16, batch=mb)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    state = adamw.init(opt_cfg, params)
    calls = []
    real = moe.moe_ffn_ep
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 16, mb, seed=1))
    try:
        moe.moe_ffn_ep = lambda *a: calls.append(a[3]) or real(*a)
        for _ in range(3):
            batch = stream.next_batch()
            rshd.set_activation_mesh(None)
            rp, r_state, m_r = r_step(rp, r_state, jax.tree.map(jnp.asarray, batch))
            params, state, m_t = step(params, state, shard_batch(batch, mesh, in_sh))
            for k in ("loss", "grad_norm"):
                assert _rel(float(m_t[k]), float(m_r[k])) <= 1e-4, k
    finally:
        moe.moe_ffn_ep = real
    assert calls and all(c is mesh for c in calls)


ARGS = ["--device", "cpu", "--arch", "stablelm-3b-smoke", "--steps", "4", "--batch",
        "4", "--seq", "32", "--save-every", "2", "--log-every", "1"]


def test_main_resumes_exactly_from_its_checkpoint(tmp_path, capsys):
    first = train.main(ARGS + ["--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "step 1", "step 2", "step 3", "step 4", "done"]
    assert CheckpointManager(tmp_path).steps() == [2, 4]
    assert set(first["save_s"]) == {2, 4} and first["restore_s"] is None
    shutil.rmtree(tmp_path / "step_4")
    second = train.main(ARGS + ["--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[restore] step 2" and out[-1] == "done"
    assert sorted(second["metrics"]) == [3, 4]
    for s in (3, 4):
        assert second["metrics"][s] == first["metrics"][s]
    for (p, a), (q, b) in zip(flatten(as_tree(first["params"])),
                              flatten(as_tree(second["params"]))):
        assert p == q and torch.equal(a, b)

    # elastic: the step-4 state onto a (2, 1) mesh, every leaf exact
    cfg = get("stablelm-3b-smoke")
    like = {"params": api.family_for(cfg).init_params(cfg, 1, device="cpu"),
            "opt": adamw.init(opt_config_for(cfg), second["params"]), "data": 0}
    mesh = shd.make_mesh((2, 1), devices="cpu")
    state = elastic.reshard_state(cfg, CheckpointManager(tmp_path), 4, like, mesh)
    assert int(state["data"]) == 4 and int(state["opt"].step) == 4
    saved = {"params": as_tree(second["params"]), "m": second["opt"].m,
             "v": second["opt"].v}
    got = {"params": as_tree(state["params"]), "m": state["opt"].m, "v": state["opt"].v}
    for k in saved:
        for (p, a), (q, b) in zip(flatten(saved[k]), flatten(got[k])):
            assert p == q and torch.equal(a, b), (k, p)
    # one more step from the resharded state gives the (1, 1) continuation
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 32, 4))
    stream.restore(4)
    batch = stream.next_batch()
    cont = {}
    for name, m, st in (("1x1", shd.make_mesh((1, 1), devices="cpu"), second),
                        ("2x1", mesh, {"params": state["params"], "opt": state["opt"]})):
        step, _, _, in_sh, _, _ = train.build(cfg, m, seq=32, batch=4)
        _, _, met = step(st["params"], st["opt"], shard_batch(batch, m, in_sh))
        cont[name] = (float(met["loss"]), float(met["grad_norm"]))
    assert cont["2x1"] == cont["1x1"]


def test_reshard_a_params_checkpoint_as_the_reference_does(tmp_path):
    cfg = get("xlstm-125m-smoke")
    params = api.family_for(cfg).init_params(cfg, 2, device="cpu")
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(3, params)
    like = api.family_for(cfg).init_params(cfg, 5, device="cpu")
    out = elastic.reshard_state(cfg, ckpt, 3, like, lmesh.make_test_mesh(2, 1, "cpu"))
    assert isinstance(out, LMParams)
    for (_, a), (_, b) in zip(flatten(as_tree(params)), flatten(as_tree(out))):
        assert torch.equal(a, b)


def test_plan_new_mesh_matches_the_reference():
    for n, mp in ((512, 16), (496, 16), (8, 4), (7, 1)):
        assert elastic.plan_new_mesh(n, model_parallel=mp) == relastic.plan_new_mesh(
            n, model_parallel=mp)
    assert elastic.plan_new_mesh(512, model_parallel=16) == (32, 16)
    assert elastic.plan_new_mesh(496, model_parallel=16) == (31, 16)
    with pytest.raises(ValueError, match="cannot keep model_parallel=16 with 8 chips"):
        elastic.plan_new_mesh(8, model_parallel=16)


def test_meshes_of_launch():
    mesh = lmesh.make_production_mesh(devices="cpu")
    assert mesh.shape == {"data": 16, "model": 16} and mesh.size == 256
    pod = lmesh.make_production_mesh(multi_pod=True, devices="cpu")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert lmesh.make_test_mesh(devices="cpu").shape == {"data": 2, "model": 2}


def test_train_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "stablelm-3b-smoke", "--steps", "2", "--batch", "4", "--seq", "32",
         "--log-every", "1"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step 1: loss ")


# ---------------------------------------------------------------------------
# Server with a mesh
# ---------------------------------------------------------------------------

def test_server_with_a_mesh_matches_the_reference_server():
    cfg, rcfg = get("stablelm-3b-smoke"), rget("stablelm-3b-smoke")
    tree = np_params(cfg, 9)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    ref = RServer(rcfg, _auto_mesh(), batch=2, prompt_cap=8, gen_cap=6)
    ref.load_weights(jax.tree.map(jnp.asarray, tree))
    want = ref.generate(prompts, 6)
    mesh = shd.make_mesh((1, 1), devices="cpu")
    server = Server(cfg, mesh, batch=2, prompt_cap=8, gen_cap=6, device="cpu")
    assert shd.activation_mesh() is mesh and server.mesh is mesh
    server.load_weights(lm_params_from_numpy(cfg, tree, device="cpu"))
    assert np.array_equal(server.generate(prompts, 6), want)
    with pytest.raises(ValueError, match="the mesh's tiles are on meta, the server on cpu"):
        Server(cfg, shd.Mesh(np.full((1, 1), torch.device("meta"), object),
                             ("data", "model")), batch=2, prompt_cap=8, device="cpu")


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_server_with_a_mesh_sends_moe_layers_through_moe_ffn_ep(shape):
    cfg, rcfg = get("moonshot-v1-16b-a3b-smoke"), rget("moonshot-v1-16b-a3b-smoke")
    tree = np_params(cfg, 11)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    ref = RServer(rcfg, _auto_mesh(), batch=2, prompt_cap=8, gen_cap=5)
    rshd.set_activation_mesh(None)  # its EP path raises on this jax
    ref.load_weights(jax.tree.map(jnp.asarray, tree))
    want = ref.generate(prompts, 5)
    mesh = shd.make_mesh(shape, devices="cpu")
    server = Server(cfg, mesh, batch=2, prompt_cap=8, gen_cap=5, device="cpu")
    server.load_weights(lm_params_from_numpy(cfg, tree, device="cpu"))
    calls = []
    real = moe.moe_ffn_ep
    try:
        moe.moe_ffn_ep = lambda *a: calls.append(a[3]) or real(*a)
        got = server.generate(prompts, 5)
    finally:
        moe.moe_ffn_ep = real
    assert len(calls) == cfg.n_layers * 5 and all(c is mesh for c in calls)
    assert np.array_equal(got, want)


def test_shard_batch_places_each_input_by_its_sharding():
    cfg = get("stablelm-3b-smoke")
    mesh = shd.make_mesh((2, 1), devices="cpu")
    shape = api.family_for(cfg).input_specs(cfg, _shape(16, 4))
    in_sh = shd.input_shardings(cfg, mesh, _shape(16, 4), shape)
    assert tuple(in_sh["tokens"].spec) == ("data", None)
    x = np.arange(64, dtype=np.int32).reshape(4, 16)
    out = shard_batch({"tokens": x}, mesh, in_sh)
    assert out["tokens"].dtype == torch.int32 and np.array_equal(out["tokens"].numpy(), x)
    with pytest.raises(ValueError, match="another mesh"):
        shard_batch({"tokens": x}, shd.make_mesh((2, 1), devices="cpu"), in_sh)


def _shape(seq, batch):
    from repro_torch.configs.base import ShapeSpec

    return ShapeSpec("t", seq, batch, "train")


def test_make_train_step_device_follows_the_mesh():
    cfg = get("stablelm-3b-smoke")
    step = make_train_step(cfg, opt_config_for(cfg), device="cpu")
    assert callable(step)
    two = np.empty(2, dtype=object)
    two[:] = [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(NotImplementedError, match="the train state on a mesh"):
        train.build(cfg, shd.Mesh(two.reshape(1, 2), ("data", "model")), seq=8, batch=4)
