"""The port's LM sharding rules (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``), spec for spec.

The reference's rules are pure functions of the mesh's axis names and
sizes, so they are reached through a duck-typed mesh (``axis_names`` and
``devices = np.empty(shape, object)``) with ``NamedSharding`` monkeypatched
in ``repro.dist.sharding`` to return the spec (and, for ``hint``,
``with_sharding_constraint`` to return its sharding) for the test's
duration: no devices are needed for (16, 16) or (2, 16, 16).  The port's
meshes are tiles of the CPU.  Tolerance: none -- every spec equals the
reference's entry for entry, at every registered arch's full config
(abstract parameters, no storage) and at each of the reference's shapes.

Also the CPU cases of ``tests/test_dist_extra.py`` (``hint`` without a
mesh, the degenerate mesh) and ``tests/test_sharding_dryrun.py`` (the
parameter rules, the cache head dims), mirrored on the port.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs.base import ALL_SHAPES as R_SHAPES
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.configs.registry import all_arch_names
from repro.configs.registry import get as rget
from repro.dist import sharding as rshd
from repro.models.api import abstract_params as r_abstract_params
from repro.models.api import family_for as r_family_for
from repro.optim import adamw as radamw
from repro_torch.configs.base import ALL_SHAPES, ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.dist import sharding as shd
from repro_torch.models.api import abstract_params, family_for
from repro_torch.models.ssm import ssm_dims
from repro_torch.optim import adamw
from repro_torch.tree import flatten

MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = all_arch_names()


class DuckMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


@pytest.fixture(autouse=True)
def no_activation_mesh():
    """Both packages' activation meshes are process-global: clear them so
    a later test on this worker does not take a mesh path unasked."""
    shd.set_activation_mesh(None)
    yield
    shd.set_activation_mesh(None)
    rshd.set_activation_mesh(None)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding functions give PartitionSpecs."""
    monkeypatch.setattr(rshd, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RP))[0]
    return {".".join(rshd._path_names(path)): tuple(spec) for path, spec in flat}


def _port_flat(tree):
    return {path: tuple(sh.spec) for path, sh in flatten(tree)}


def _meshes(shape, names):
    return shd.make_mesh(shape, names, devices="cpu"), DuckMesh(shape, names)


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_shardings_match_reference(ref_specs, arch, shape, names):
    cfg, rcfg = get(arch), rget(arch)
    mesh, rmesh = _meshes(shape, names)
    p_sh = shd.param_shardings(cfg, mesh, abstract_params(cfg))
    r_sh = rshd.param_shardings(rcfg, rmesh, r_abstract_params(rcfg))
    got, want = _port_flat(p_sh), _ref_flat(r_sh)
    assert got == want
    assert all(sh.mesh is mesh for _, sh in flatten(p_sh))
    o_sh = shd.opt_shardings(cfg, mesh, adamw.init_specs(adamw.AdamWConfig(),
                                                         abstract_params(cfg)), p_sh)
    r_o = rshd.opt_shardings(rcfg, rmesh, None, r_sh)
    assert tuple(o_sh.step.spec) == tuple(r_o.step) == ()
    assert isinstance(o_sh, adamw.AdamWState) and isinstance(r_o, radamw.AdamWState)
    assert _port_flat(o_sh.m) == _port_flat(o_sh.v) == _ref_flat(r_o.m) == want


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_shardings_match_reference(ref_specs, arch, shape, names):
    cfg, rcfg = get(arch), rget(arch)
    mesh, rmesh = _meshes(shape, names)
    fam, rfam = family_for(cfg), r_family_for(rcfg)
    shapes = list(ALL_SHAPES) + [ShapeSpec("decode_b8", 64, 8, "decode")]
    r_shapes = list(R_SHAPES) + [RShapeSpec("decode_b8", 64, 8, "decode")]
    for s, rs in zip(shapes, r_shapes):
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            rs.name, rs.seq_len, rs.global_batch, rs.kind)
        got = _port_flat(shd.input_shardings(cfg, mesh, s, fam.input_specs(cfg, s)))
        want = _ref_flat(rshd.input_shardings(rcfg, rmesh, rs, rfam.input_specs(rcfg, rs)))
        assert got == want, s.name
        if s.kind != "decode":
            continue
        c_sh = shd.cache_shardings(cfg, mesh, s, fam.cache_specs(cfg, s))
        r_c = rshd.cache_shardings(rcfg, rmesh, rs, rfam.cache_specs(rcfg, rs))
        got = [tuple(sh.spec) for sh in shd_leaves(c_sh)]
        want = [tuple(p) for p in jax.tree.leaves(r_c, is_leaf=lambda x: isinstance(x, RP))]
        assert got == want, s.name


def shd_leaves(tree):
    out = []
    shd.map_leaves(out.append, tree)
    return out


@pytest.mark.parametrize("shape,names", MESHES)
def test_hint_spec_matches_reference(ref_specs, shape, names):
    mesh, rmesh = _meshes(shape, names)
    shd.set_activation_mesh(mesh)
    rshd.set_activation_mesh(rmesh)
    cases = [((32, 16, 512), ("batch", None, None)),
             ((32, 16, 512), ("batch", None, "model")),
             ((6, 5, 3), ("batch", None, "model")),
             ((64, 7, 48), ("batch", "data", "model")),
             ((8, 4), ("model", "pod"))]
    for shp, axes in cases:
        x = torch.zeros(shp)
        assert shd.hint(x, *axes) is x
        assert tuple(shd.hint_spec(x, *axes)) == tuple(rshd.hint(jax.numpy.zeros(shp), *axes))


def test_hint_noop_without_mesh():
    x = torch.ones((4, 8))
    assert shd.hint(x, "batch", None) is x
    assert shd.hint_spec(x, "batch", None) is None


def test_partition_spec_stores_entries_as_jax_does():
    for entries in [(), (None,), ("data",), (("data",), None), ((), "model"),
                    (("pod", "data"), None, "model")]:
        assert tuple(shd.PartitionSpec(*entries)) == tuple(RP(*entries))


def test_param_shardings_degenerate_mesh():
    """(1,1) mesh: every leaf gets exactly one sharding and the big matrices
    still carry the model axis in their spec (size-1 axes are free)."""
    mesh = shd.make_mesh((1, 1), ("data", "model"), devices="cpu")
    cfg = get("starcoder2-7b")
    specs = abstract_params(cfg)
    sh = shd.param_shardings(cfg, mesh, specs)
    assert len(flatten(sh)) == len(flatten(specs))
    assert sh["embed"].spec[0] == "model"
    for name in ("wq", "wk", "wv", "wo"):
        assert "model" in tuple(sh["layers"]["attn"][name].spec)
    for name in ("w_gate", "w_up", "w_down"):
        assert "model" in tuple(sh["layers"]["mlp"][name].spec)
    assert tuple(sh["final_norm"].spec) == ()
    moe_cfg = get("moonshot-v1-16b-a3b")
    moe_sh = shd.param_shardings(moe_cfg, mesh, abstract_params(moe_cfg))
    assert moe_sh["layers"]["moe"]["w_gate"].spec[1] == "model"


def test_param_sharding_rules():
    mesh = shd.make_mesh((1, 1), ("data", "model"), devices="cpu")
    for arch in ("starcoder2-7b", "llama4-maverick-400b-a17b", "zamba2-2.7b",
                 "xlstm-125m", "whisper-medium"):
        cfg = get(arch)
        specs = abstract_params(cfg)
        assert len(flatten(shd.param_shardings(cfg, mesh, specs))) == len(flatten(specs))


def test_cache_sharding_rules_head_dims():
    """Decode caches get batch+HEAD sharding for every cache family --
    attention KV at dim 3, SSM state / mLSTM matrix-memory at their own
    head dims -- while headless leaves stay batch-only."""
    mesh = shd.make_mesh((1, 1), ("data", "model"), devices="cpu")

    def specs_for(cfg, batch=8):
        shape = ShapeSpec("t", 64, batch, "decode")
        c_specs = family_for(cfg).cache_specs(cfg, shape)
        return shd_leaves(c_specs), shd_leaves(shd.cache_shardings(cfg, mesh, shape, c_specs))

    def model_dims(sh):
        return [d for d, ax in enumerate(sh.spec) if ax == "model"]

    cfg = get("starcoder2-7b")
    for leaf, sh in zip(*specs_for(cfg)):
        assert sh.spec[1] is not None
        assert model_dims(sh) == [3] and leaf.shape[3] == cfg.n_kv_heads

    cfg = get("xlstm-125m")
    for leaf, sh in zip(*specs_for(cfg)):
        assert sh.spec[1] is not None
        if leaf.dim() >= 3 and leaf.shape[2] == cfg.n_heads:
            assert model_dims(sh) == [2], leaf.shape
        else:
            assert model_dims(sh) == [], leaf.shape

    collide = dataclasses.replace(get("xlstm-125m"), name="xlstm-collide", d_model=64,
                                  n_heads=8, n_kv_heads=8)
    for leaf, sh in zip(*specs_for(collide, batch=16)):
        assert sh.spec[1] is not None
        if leaf.dim() >= 3 and leaf.shape[2] == collide.n_heads:
            assert model_dims(sh) == [2], leaf.shape
        else:
            assert model_dims(sh) == [], leaf.shape

    cfg = get("zamba2-2.7b")
    H_ssm = ssm_dims(cfg)[1]
    saw = set()
    for leaf, sh in zip(*specs_for(cfg)):
        if leaf.dim() == 6:
            assert sh.spec[2] is not None
            assert model_dims(sh) == [3] and leaf.shape[3] == H_ssm
            saw.add("ssm")
        elif leaf.dim() == 5 and leaf.shape[3] == cfg.n_kv_heads:
            assert sh.spec[1] is not None and model_dims(sh) == [3]
            saw.add("kv")
        else:
            assert model_dims(sh) == [], leaf.shape
    assert saw == {"ssm", "kv"}


def test_place_keeps_the_whole_tensor_on_the_mesh_device():
    mesh = shd.make_mesh((2, 2), ("data", "model"), devices="cpu")
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    t = shd.place(x, shd.NamedSharding(mesh, shd.P("data", "model")), "x")
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), x)
    with pytest.raises(ValueError, match="leaf 'x'.*splits dim 1"):
        shd.place(np.zeros((4, 5)), shd.NamedSharding(mesh, shd.P(None, "model")), "x")
    with pytest.raises(ValueError, match="names no axis 'pod'"):
        shd.place(np.zeros((4, 4)), shd.NamedSharding(mesh, shd.P("pod")), "x")
    two = np.empty(2, dtype=object)
    two[:] = [torch.device("cpu"), torch.device("meta")]
    split = shd.Mesh(two.reshape(1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match=r"leaf 'w' with spec .*'model'"):
        shd.place(np.zeros((2, 4)), shd.NamedSharding(split, shd.P(None, "model")), "w")
