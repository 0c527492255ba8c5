"""The port's checkpointing and fault-tolerance supervisor
(``repro_torch.checkpoint.manager``, ``repro_torch.runtime_ft.supervisor``)
against the reference's: the cases of tests/test_checkpoint_ft.py on torch
trees, JAX's flatten order and leaf names, and checkpoints that cross
between the packages both ways (dicts built in unsorted key order,
tuples, lists, ``None``, uint32 key words, int32 and bool states)."""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import manager as jmanager
from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import prng
from repro_torch.runtime_ft.supervisor import (
    HeartbeatTracker,
    StragglerMonitor,
    run_with_restarts,
)


def _state():
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "opt": {"m": torch.zeros((3, 4)), "step": torch.tensor(0, dtype=torch.int32)},
    }


def _leaves(tree):
    return manager._flatten_with_names(tree)[1]


def test_save_restore_roundtrip(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    st = _state()
    ckpt.save(5, st)
    out = ckpt.restore(5, like=_state())
    for a, b in zip(_leaves(st), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomicity_no_tmp_left(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, _state())
    assert not list(tmp_path.glob("*.tmp"))
    assert ckpt.latest_step() == 1


def test_gc_keeps_last(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _state())
    assert ckpt.steps() == [3, 4]


def test_restart_recovers_and_completes(tmp_path):
    """Inject a crash at step 17; the supervisor restores from step 10 and
    completes all 30 steps with exactly-once semantics on the counter."""
    ckpt = CheckpointManager(tmp_path)
    crashed = {"done": False}

    def make_state():
        return {"count": torch.tensor(0, dtype=torch.int32)}

    def step_fn(state, step):
        return {"count": state["count"] + 1}

    def fault(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    state, stats = run_with_restarts(
        total_steps=30, make_state=make_state, step_fn=step_fn,
        ckpt=ckpt, save_every=10, fault_injector=fault,
    )
    assert stats.restarts == 1
    assert stats.restored_from == 10
    assert int(state["count"]) == 30


def test_straggler_detection():
    mon = StragglerMonitor(deadline_factor=2.0, max_strikes=2)
    for _ in range(10):
        assert mon.observe("h0", 1.0) == "ok"
    assert mon.observe("h1", 5.0) == "suspect"
    assert mon.observe("h1", 5.0) == "evict"
    # healthy host clears strikes
    mon.observe("h2", 5.0)
    assert mon.observe("h2", 1.0) == "ok"
    assert "h2" not in mon.strikes


def test_heartbeat_dead_host():
    t = {"now": 0.0}
    hb = HeartbeatTracker(timeout_s=10, clock=lambda: t["now"])
    hb.beat("a")
    hb.beat("b")
    t["now"] = 5.0
    hb.beat("a")
    t["now"] = 12.0
    assert hb.dead_hosts() == ["b"]


def test_async_save(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    st = _state()
    t = ckpt.save_async(7, st)
    st["w"].add_(100.0)  # an update after the call misses the checkpoint
    t.join(timeout=60)
    assert not t.is_alive()
    out = ckpt.restore(7, like=_state())
    assert torch.equal(out["w"], _state()["w"])
    assert not list(tmp_path.glob("*.tmp"))


# -- across the packages ------------------------------------------------------

NT = collections.namedtuple("NT", "b a")


def _numpy_tree(seed):
    """The leaves as numpy arrays, in containers JAX and the port flatten
    alike: dicts built in unsorted key order, tuples, lists, ``None``."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    key[0] = 0xFFFFFFF0  # a word above the int32 range
    return {
        "zeta": {"state": rng.integers(1, 257, (3, 4, 20)).astype(np.int32),
                 "mask": rng.random((5, 7)) < 0.5},
        "alpha": (key, [rng.standard_normal((3, 4)).astype(np.float32), None,
                        np.int32(seed)]),
        "mid": [None, (rng.random(9) < 0.5,)],
    }


def _map(fn, tree):
    return jax.tree.map(fn, tree)


def _torch_like(tree, key_as_tensor):
    """The port's tree of the same structure: tensors, the key as the
    port's int64 words (or the uint32 words as ``prng.key_data`` gives
    them)."""
    out = _map(torch.from_numpy, _map(np.asarray, tree))
    key = convert.key_from_numpy(tree["alpha"][0])
    out["alpha"] = (key if key_as_tensor else prng.key_data(key), out["alpha"][1])
    return out


def test_flatten_follows_jax_order_and_names():
    tree = {
        "z": 1, "a": [2, None, (3,)], "n": NT(6, 7), "e": {},
        "o": collections.OrderedDict([("y", 4), ("x", 5)]),
        "d": collections.defaultdict(int, {"q": 8, "p": 9}),
    }
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    names, leaves = manager._flatten_with_names(tree)
    assert (names, leaves) == jmanager._flatten_with_names(tree)[:2]
    assert names == ["a/0", "a/2/0", "d/p", "d/q", "n/.b", "n/.a", "o/y", "o/x", "z"]
    rebuilt = manager._map(lambda x: x * 10, tree)
    assert rebuilt == jax.tree.unflatten(treedef, [x * 10 for _, x in flat])
    assert isinstance(rebuilt["d"], collections.defaultdict)
    assert list(rebuilt["o"]) == ["y", "x"] and list(rebuilt) == sorted(tree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _numpy_tree(0)
    jmanager.CheckpointManager(tmp_path).save(3, _map(jnp.asarray, tree))
    like = _map(torch.zeros_like, _torch_like(tree, key_as_tensor=True))
    out = CheckpointManager(tmp_path).restore(3, like=like)
    want = _torch_like(tree, key_as_tensor=True)
    names, got = manager._flatten_with_names(out)
    assert names == manager._flatten_with_names(want)[0]
    for name, a, b in zip(names, got, _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert out["alpha"][0].dtype == torch.int64  # the port's key words
    assert torch.equal(out["alpha"][0], convert.key_from_numpy(tree["alpha"][0]))
    assert out["alpha"][1][1] is None and out["mid"][0] is None


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _numpy_tree(1)
    CheckpointManager(tmp_path).save(4, _torch_like(tree, key_as_tensor=False))
    like = _map(jnp.zeros_like, _map(jnp.asarray, tree))
    out = jmanager.CheckpointManager(tmp_path).restore(4, like=like)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    # and the port restores its own save, the key words as int64
    mine = CheckpointManager(tmp_path).restore(
        4, like=_torch_like(tree, key_as_tensor=True))
    assert torch.equal(mine["alpha"][0], convert.key_from_numpy(tree["alpha"][0]))


def test_restore_casts_to_like_and_raises_on_lost_values(tmp_path):
    """The port restores into the dtype and onto the device of ``like``'s
    leaf (the reference keeps the saved dtype): uint32 key words become
    int64 words; a value the cast would change raises."""
    ckpt = CheckpointManager(tmp_path)
    words = np.array([0xFFFFFFF0, 7], np.uint32)
    ckpt.save(1, {"key": words, "big": torch.tensor([2 ** 40]), "half": np.float32(0.5)})
    out = ckpt.restore(1, like={
        "key": torch.zeros(2, dtype=torch.int64),
        "big": torch.zeros(1, dtype=torch.int64, device="meta"),
        "half": torch.zeros((), dtype=torch.float64),
    })
    assert torch.equal(out["key"], convert.key_from_numpy(words))
    assert out["big"].device.type == "meta" and out["half"].item() == 0.5
    jout = jmanager.CheckpointManager(tmp_path).restore(
        1, like={"key": 0, "big": 0, "half": 0})
    assert jout["key"].dtype == jnp.uint32  # the reference keeps the saved dtype
    for like, what in (
        ({"key": torch.zeros(2, dtype=torch.int32)}, "key"),
        ({"big": torch.zeros(1, dtype=torch.int32)}, "big"),
        ({"half": torch.zeros((), dtype=torch.int64)}, "half"),
    ):
        full = {"key": torch.zeros(2, dtype=torch.int64),
                "big": torch.zeros(1, dtype=torch.int64),
                "half": torch.zeros((), dtype=torch.float32), **like}
        with pytest.raises(ValueError, match=f"leaf '{what}'.*do not survive"):
            ckpt.restore(1, like=full)


def test_structure_mismatch_raises_like_the_reference(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(2, {"a": torch.zeros(1), "b": torch.zeros(1)})
    with pytest.raises(AssertionError, match="tree structure mismatch"):
        ckpt.restore(2, like={"a": torch.zeros(1)})
    with pytest.raises(AssertionError, match="leaf order mismatch: c != b"):
        ckpt.restore(2, like={"c": torch.zeros(1), "a": torch.zeros(1)})
