"""Checkpoints of the LM train state on a rank mesh: written on four gloo
ranks of a (2, 2) mesh in the reference's layout, restored on two ranks
(another process group, after the first has ended) and in one process,
resharded 4 -> 2 by ``runtime_ft.elastic.reshard_state``, and
``launch.train.main`` resumed under four ranks.

The state is stablelm-3b-smoke's: params from ``init_params`` (bf16,
seed 0), fp32 moments drawn from numpy, step 7, data position 5.
Tolerance: none -- every restored block and every resumed loss,
gradient norm and parameter is equal (``torch.equal``, ``==``), and the
manifest equals the reference's leaf for leaf.  Beside the one-process
run of the same CLI (bf16), losses within 1e-4 and gradient norms within
1e-3 relative.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import train
from repro_torch.launch.mesh import init_distributed
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime_ft import elastic
from repro_torch.tree import as_tree, flatten, unflatten

ARCH = "stablelm-3b-smoke"
STEP, DATA = 7, 5
ARGS = ["--device", "cpu", "--arch", ARCH, "--steps", "4", "--batch", "8", "--seq", "32",
        "--save-every", "2", "--log-every", "1", "--mesh", "2x2"]


def state(cfg):
    """The whole logical train state, on the CPU."""
    params = api.family_for(cfg).init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    m, v = ({p: torch.from_numpy(draw(size=tuple(t.shape)).astype(np.float32))
             for p, t in flatten(as_tree(params))} for draw in (rng.normal, rng.random))
    opt = adamw.AdamWState(step=torch.tensor(STEP, dtype=torch.int32),
                           m=unflatten(m.items()), v=unflatten(v.items()))
    return {"params": params, "opt": opt, "data": DATA}


def shardings(cfg, mesh):
    p_sh = shd.param_shardings(cfg, mesh, api.family_for(cfg).param_specs(cfg))
    return {"params": p_sh, "opt": shd.opt_shardings(cfg, mesh, None, p_sh),
            "data": shd.replicated(mesh)}


def whole(tree):
    """{name: the logical tensor} of a state (gathered from its blocks)."""
    out = {}
    for path, t in flatten({"params": as_tree(tree["params"]), "m": tree["opt"].m,
                            "v": tree["opt"].v}):
        out[path] = (collectives.gather_full(t) if shd._is_dtensor(t) else t).clone()
    out["step"] = shd.local(tree["opt"].step).clone()
    out["data"] = torch.as_tensor(shd.local(tree["data"])).clone()
    return out


def blocks(tree):
    return {path: shd.local(t).clone() for path, t in flatten(
        {"params": as_tree(tree["params"]), "m": tree["opt"].m, "v": tree["opt"].v})}


def _save_on_four(d):
    cfg = get(ARCH)
    mesh = shd.make_mesh((2, 2), devices="cpu", distributed=True)
    sh = shardings(cfg, mesh)
    st = state(cfg)
    placed = {"params": shd.place_tree(st["params"], sh["params"]),
              "opt": adamw.AdamWState(step=shd.place(st["opt"].step, sh["opt"].step),
                                      m=shd.place_tree(st["opt"].m, sh["params"]),
                                      v=shd.place_tree(st["opt"].v, sh["params"])),
              "data": DATA}
    ckpt = CheckpointManager(d / "state")
    ckpt.save(STEP, placed)
    return {"latest": ckpt.latest_step(), "whole": whole(placed)}


def _main_on_four(d):
    out = {}
    for run in ("first", "second"):
        if run == "second" and torch.distributed.get_rank() == 0:
            shutil.rmtree(d / "main" / "step_4")
        torch.distributed.barrier()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rec = train.main(ARGS + ["--ckpt", str(d / "main")])
        out[run] = {"metrics": rec["metrics"], "stdout": text.getvalue(),
                    "whole": whole({"params": rec["params"], "opt": rec["opt"],
                                    "data": 0}),
                    "steps": CheckpointManager(d / "main").steps()}
    return out


def _restore_on_two(d):
    cfg = get(ARCH)
    like = state(cfg)
    like["params"] = api.family_for(cfg).init_params(cfg, 1, device="cpu")
    ckpt = CheckpointManager(d / "state")
    out = {}
    for name, shape in (("restore", (2, 1)), ("reshard", (1, 2))):
        mesh = shd.make_mesh(shape, devices="cpu", distributed=True)
        if name == "restore":
            got = ckpt.restore(STEP, like=like, shardings=shardings(cfg, mesh))
        else:
            got = elastic.reshard_state(cfg, ckpt, STEP, like, mesh)
        out[name] = {"coords": mesh.coords, "blocks": blocks(got), "whole": whole(got),
                     "dtensor": all(shd._is_dtensor(t) for _, t in flatten(
                         as_tree(got["params"])))}
    return out


def _worker(rank, world, store, d, out_dir):
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                     timeout_s=300)
    from pathlib import Path

    d = Path(d)
    if world == 4:
        res = {"save": _save_on_four(d), "main": _main_on_four(d)}
    else:
        res = _restore_on_two(d)
    torch.save(res, os.path.join(out_dir, f"w{world}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multirank_ckpt")
    out = {}
    for world in (4, 2):
        mp.spawn(_worker, args=(world, str(d / f"store{world}"), str(d), str(d)),
                 nprocs=world, join=True)
        out[world] = [torch.load(d / f"w{world}_rank{r}.pt", weights_only=False)
                      for r in range(world)]
    out["dir"] = d
    return out


@pytest.fixture(autouse=True)
def no_activation_mesh():
    yield
    shd.set_activation_mesh(None)


def _want():
    cfg = get(ARCH)
    return whole(state(cfg))


def test_a_save_on_four_ranks_is_the_whole_state_and_visible_on_every_rank(runs):
    want = _want()
    for r in runs[4]:
        assert r["save"]["latest"] == STEP
        got = r["save"]["whole"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_the_manifest_is_the_references_leaf_for_leaf(runs):
    import jax

    from repro.checkpoint.manager import CheckpointManager as RManager
    from repro.configs.registry import get as rget
    from repro.dist import steps as rsteps
    from repro.models.api import family_for as r_family_for
    from repro.optim import adamw as radamw

    rcfg = rget(ARCH)
    rp = r_family_for(rcfg).init_params(rcfg, jax.random.key(0))
    ref = runs["dir"] / "ref"
    RManager(ref).save(STEP, {"params": rp, "opt": radamw.init(
        rsteps.opt_config_for(rcfg), rp), "data": DATA})
    read = lambda p: json.loads((p / f"step_{STEP}" / "manifest.json").read_text())  # noqa: E731
    assert read(runs["dir"] / "state") == read(ref)


@pytest.mark.parametrize("how", ["restore", "reshard"])
def test_two_ranks_restore_the_four_rank_checkpoint_exactly(runs, how):
    """restore(shardings=) onto (2, 1) and ``reshard_state`` onto (1, 2):
    each rank's blocks are those of the saved arrays, bit for bit."""
    want = _want()
    for r in runs[2]:
        got = r[how]
        assert got["dtensor"]
        for k in want:
            assert torch.equal(got["whole"][k], want[k]), k
        mesh_shape = (2, 1) if how == "restore" else (1, 2)
        p_sh = shd.param_shardings(get(ARCH), shd.make_mesh(mesh_shape, devices="cpu"),
                                   api.family_for(get(ARCH)).param_specs(get(ARCH)))
        specs = {path: sh.spec for path, sh in flatten(p_sh)}
        sizes = dict(zip(("data", "model"), mesh_shape))
        for path, block in got["blocks"].items():
            spec = specs[path.split(".", 1)[1]]
            index = []
            for dim, n in enumerate(want[path].shape):
                entry = spec[dim] if dim < len(spec) else None
                parts = sizes[entry] if entry else 1
                i = got["coords"][entry] if entry else 0
                index.append(slice(i * n // parts, (i + 1) * n // parts))
            assert torch.equal(block, want[path][tuple(index)]), path


def test_one_process_restores_the_four_rank_checkpoint_exactly(runs):
    cfg = get(ARCH)
    like = state(cfg)
    ckpt = CheckpointManager(runs["dir"] / "state")
    want = _want()
    for got in (ckpt.restore(STEP, like=like),
                elastic.reshard_state(cfg, ckpt, STEP, like,
                                      shd.make_mesh((1, 1), devices="cpu"))):
        got = whole(got)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_main_resumes_exactly_under_four_ranks(runs):
    first = [r["main"]["first"] for r in runs[4]]
    second = [r["main"]["second"] for r in runs[4]]
    assert [line.split(":")[0] for line in first[0]["stdout"].splitlines()] == [
        "step 1", "step 2", "step 3", "step 4", "done"]
    assert second[0]["stdout"].splitlines()[0] == "[restore] step 2"
    assert all(r["stdout"] == "" for r in first[1:] + second[1:])
    assert first[0]["steps"] == [2, 4] and second[0]["steps"] == [2, 4]
    for a, b in zip(first, second):
        assert a["metrics"] == first[0]["metrics"] and b["metrics"] == second[0]["metrics"]
        for s in (3, 4):
            assert b["metrics"][s] == a["metrics"][s]
        for k in a["whole"]:
            assert torch.equal(a["whole"][k], b["whole"][k]), k
    # beside the one-process run of the same CLI: bf16 params, so the
    # gradient norm within 1e-3 (the data-parallel reduce-scatter rounds
    # a bf16 gradient's sum once more than the one-process product does)
    one = train.main([a for a in ARGS if a not in ("--mesh", "2x2")])
    for s in (1, 2, 3, 4):
        loss, gnorm = first[0]["metrics"][s]
        o_loss, o_gnorm = one["metrics"][s]
        assert abs(loss - o_loss) <= 1e-4 * abs(o_loss)
        assert abs(gnorm - o_gnorm) <= 1e-3 * abs(o_gnorm)
