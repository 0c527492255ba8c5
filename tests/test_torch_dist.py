"""repro_torch.dist on the CPU against the JAX reference (tolerance 0):
the port's meshes and batch-axis rule, the three local plan executors on
the same numpy operands (include-major chunks spanning clauses, packed,
clause-major), the clause tables and operands built from one program,
the ``clause_table`` twin, and ``build_tm_sharded`` on CPU meshes of 1, 2,
3 and 4 tiles against the dense oracle and the reference's clause-major
executor.

The reference's own ``build_tm_sharded`` fn does not run on this jax
(``shard_map(check_rep=)``), so the sharded results are held to the
reference functions that do: its local executors, ``fill_clause_tables``,
``operands_from_plan`` and ``batch_class_sums``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist.tm_sharded as jtms
from repro.accel import CapacityPlan as JCapacityPlan
from repro.accel import TMProgram as JTMProgram
from repro.core import TMConfig as JTMConfig
from repro.core import batch_class_sums, pack_literals as jpack_literals
from repro.core import state_from_actions as jstate_from_actions
from repro.core.compress import decode_to_plan as jdecode_to_plan
from repro.core.compress import encode as jencode
from repro.dist import sharding as jshd
from repro_torch.accel import TMProgram
from repro_torch.core import TMConfig, pack_literals
from repro_torch.core.bits import from_u32
from repro_torch.core.compress import decode_to_plan, encode
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import tm_sharded as tms
from repro_torch.kernels.clause_table import clause_table, clause_table_plain
from repro_torch.kernels.clause_table import kernel as ctk

CPU_MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]


def _stub(shape, axes):
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


# -- meshes and the batch-axis rule -------------------------------------------


@pytest.mark.parametrize("shape,axes", [
    ((4,), ("data",)), ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((1, 1), ("data", "model")), ((3, 2), ("data", "model")), ((2, 3), ("model", "data")),
])
@pytest.mark.parametrize("B", [1, 2, 8, 12, 64])
def test_axis_sizes_and_batch_axes_match_the_reference(shape, axes, B):
    mesh = shd.make_mesh(shape, axes, devices="cpu")
    assert mesh.devices.shape == shape and mesh.axis_names == axes
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert shd._axis_sizes(mesh) == jshd._axis_sizes(_stub(shape, axes))
    assert mesh.shape == shd._axis_sizes(mesh)
    # the reference's functions read the port's mesh as they read theirs
    assert shd.batch_axes(mesh, B) == jshd.batch_axes(_stub(shape, axes), B)
    assert shd.batch_axes(mesh, B) == jshd.batch_axes(mesh, B)
    shards = shd.batch_shards(mesh, B)
    sizes = mesh.shape
    assert len(shards) == int(np.prod([sizes[a] for a in shd.batch_axes(mesh, B) or ()]))
    assert [i for _, i in shards] == list(range(len(shards)))


def test_make_mesh_places_devices_and_refuses_bad_grids():
    mesh = shd.make_mesh((2, 2), devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.first_device == torch.device("cpu")
    assert mesh.device_at({"model": 1}) == torch.device("cpu")
    with pytest.raises(ValueError, match="3 devices for a mesh of 4"):
        shd.make_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="does not match"):
        shd.make_mesh((2, 2), ("data",), devices="cpu")
    with pytest.raises(ValueError, match="repeat"):
        shd.make_mesh((2, 2), ("model", "model"), devices="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        shd.make_mesh((1, 1), devices="mps")
    # the dry run's mesh: spec arithmetic on the meta device, asked by name
    assert shd.make_mesh((2, 2), devices="meta").first_device == torch.device("meta")


def test_make_mesh_without_devices_sits_on_the_card():
    if torch.cuda.is_available():
        assert shd.make_mesh((1, 2)).first_device == resolve_device(None)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shd.make_mesh((1, 1))


# -- the local executors -------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    """Four classes of ten clauses over 30 features: the reference test's
    dense clauses (spanning chunks of 16) and sparse ones that fire, one
    model weightless and one weighted."""
    rng = np.random.default_rng(5)
    cfg, jcfg = TMConfig(4, 10, 30), JTMConfig(4, 10, 30)
    acts = rng.random((4, 10, 60)) < 0.25
    acts[:, 5:] = rng.random((4, 5, 60)) < 0.05  # clauses that fire
    acts[2, 7] = False  # an empty clause: never in the plan
    w = rng.integers(1, 8, (4, 10))
    X = rng.integers(0, 2, (64, 30)).astype(np.uint8)
    state = jstate_from_actions(jcfg, jnp.asarray(acts))
    oracle = np.asarray(batch_class_sums(jcfg, state, jnp.asarray(X)))
    assert np.abs(oracle).sum() > 0
    plans = {
        "weightless": (decode_to_plan(encode(cfg, acts)),
                       jdecode_to_plan(jencode(jcfg, acts))),
        "weighted": (decode_to_plan(encode(cfg, acts, w)),
                     jdecode_to_plan(jencode(jcfg, acts, w))),
    }
    return cfg, acts, w, X, oracle, plans


def _operands(plan, chunk):
    """The include-major operands of tests/test_tm_sharded.py."""
    n_inc = plan.n_includes
    I_cap = -(-n_inc // chunk) * chunk
    lit_idx = np.zeros(I_cap, np.int32)
    lit_idx[:n_inc] = plan.lit_idx
    seg_last = np.zeros(I_cap, np.int32)
    seg_last[:n_inc][
        np.concatenate([plan.clause_id[1:] != plan.clause_id[:-1], [True]])
    ] = 1
    cid = np.full(I_cap, plan.n_clauses_total, np.int32)
    cid[:n_inc] = plan.clause_id
    return lit_idx, seg_last, cid


def _jlits(X):
    return np.asarray(jax.vmap(lambda r: jnp.stack([r, ~r], -1).reshape(-1))(
        jnp.asarray(X, bool))).astype(np.int8)


def test_plans_of_one_program_are_equal(case):
    _, _, _, _, _, plans = case
    for ours, theirs in plans.values():
        for f in ("lit_idx", "clause_id", "clause_class", "clause_pol"):
            assert np.array_equal(getattr(ours, f), getattr(theirs, f))
        assert np.array_equal(ours.weighted_pol, theirs.weighted_pol)


@pytest.mark.parametrize("chunk", [16, 512])
@pytest.mark.parametrize("kind", ["weightless", "weighted"])
def test_include_major_executors_match_the_reference(case, monkeypatch, chunk, kind):
    monkeypatch.setattr(tms, "CHUNK", chunk)
    monkeypatch.setattr(jtms, "CHUNK", chunk)
    cfg, acts, w, X, oracle, plans = case
    plan, jplan = plans[kind]
    lit_idx, seg_last, cid = _operands(plan, chunk)
    pol = plan.weighted_pol
    lits = _jlits(X)
    want = np.asarray(jtms._local_plan_executor(
        jnp.asarray(lit_idx), jnp.asarray(cid), jnp.asarray(plan.clause_class),
        jnp.asarray(pol), jnp.asarray(lits)))
    got = tms._local_plan_executor(
        torch.from_numpy(lit_idx), torch.from_numpy(cid),
        torch.from_numpy(plan.clause_class), torch.from_numpy(pol),
        torch.from_numpy(lits))
    assert np.array_equal(got.numpy(), want)
    jpacked = jpack_literals(jnp.asarray(X))
    want_p = np.asarray(jtms._local_plan_executor_packed(
        jnp.asarray(lit_idx), jnp.asarray(seg_last), jnp.asarray(plan.clause_class),
        jnp.asarray(pol), jpacked))
    got_p = tms._local_plan_executor_packed(
        torch.from_numpy(lit_idx), torch.from_numpy(seg_last),
        torch.from_numpy(plan.clause_class), torch.from_numpy(pol),
        pack_literals(torch.from_numpy(X)))
    assert np.array_equal(got_p.numpy(), want_p)
    if kind == "weightless":
        assert np.array_equal(want[: cfg.n_classes, :64].T, oracle)
        assert np.array_equal(want_p[: cfg.n_classes, :64].T, oracle)


def test_include_capacity_off_the_chunk_raises(case, monkeypatch):
    monkeypatch.setattr(tms, "CHUNK", 16)
    _, _, _, X, _, plans = case
    plan = plans["weightless"][0]
    lit_idx, _, cid = _operands(plan, 16)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tms._local_plan_executor(
            torch.from_numpy(lit_idx[:-1]), torch.from_numpy(cid[:-1]),
            torch.from_numpy(plan.clause_class), torch.from_numpy(plan.clause_pol),
            torch.from_numpy(_jlits(X)))


def _clause_major(plan, F2, Lc=None, empty_row=False):
    NCL = plan.n_clauses_total
    counts = np.bincount(plan.clause_id, minlength=NCL)
    Lc = int(counts.max()) if Lc is None else Lc
    pad_idx = np.full((NCL + empty_row, Lc), F2, np.int32)  # ones row
    for c in range(NCL):
        ks = plan.lit_idx[plan.clause_id == c]
        pad_idx[c, : len(ks)] = ks
    cls = np.concatenate([plan.clause_class, [1] * empty_row]).astype(np.int32)
    pol = np.concatenate([plan.weighted_pol, [3] * empty_row]).astype(np.int32)
    return pad_idx, cls, pol


def _packed1(X):
    packed = np.asarray(jpack_literals(jnp.asarray(X)))
    return np.concatenate(
        [packed, np.full((1, packed.shape[1]), 0xFFFFFFFF, np.uint32)])


@pytest.mark.parametrize("kind", ["weightless", "weighted"])
def test_clause_major_executor_matches_the_reference(case, kind):
    cfg, acts, w, X, oracle, plans = case
    plan = plans[kind][0]
    pad_idx, cls, pol = _clause_major(plan, 60)
    packed1 = _packed1(X)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(pad_idx), jnp.asarray(cls), jnp.asarray(pol), jnp.asarray(packed1)))
    got = tms._local_plan_executor_clausemajor(
        torch.from_numpy(pad_idx), torch.from_numpy(cls), torch.from_numpy(pol),
        from_u32(packed1))
    assert np.array_equal(got.numpy(), want)
    if kind == "weightless":
        assert np.array_equal(want[: cfg.n_classes, :64].T, oracle)


def test_empty_clause_fires_in_the_clause_major_executor(case):
    """Divergence of the reference kept by the port: a clause row made of
    pads only ANDs the all-ones row and fires everywhere (the reference's
    reduction starts from all ones), where the dense oracle gives an
    empty clause 0.  ``decode_to_plan`` never emits such a clause."""
    cfg, acts, w, X, oracle, plans = case
    plan = plans["weightless"][0]
    pad_idx, cls, pol = _clause_major(plan, 60, empty_row=True)
    assert (pad_idx[-1] == 60).all() and cls[-1] == 1 and pol[-1] == 3
    packed1 = _packed1(X)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(pad_idx), jnp.asarray(cls), jnp.asarray(pol), jnp.asarray(packed1)))
    got = tms._local_plan_executor_clausemajor(
        torch.from_numpy(pad_idx), torch.from_numpy(cls), torch.from_numpy(pol),
        from_u32(packed1)).numpy()
    assert np.array_equal(got, want)
    diff = got[: cfg.n_classes, :64].T - oracle
    assert (diff[:, 1] == 3).all() and (np.delete(diff, 1, axis=1) == 0).all()


def test_clause_major_index_and_class_rules_follow_the_reference(case):
    """Indices in [-n, 0) count from the end and others read as all ones
    (the reference's take); classes in [-n_out, 0) count from the end and
    others drop (its scatter)."""
    _, _, _, X, _, plans = case
    plan = plans["weightless"][0]
    pad_idx, cls, pol = _clause_major(plan, 60)
    rng = np.random.default_rng(9)
    pad_idx[:, -1] = rng.choice([-1, -61, -62, 61, 200, 5], pad_idx.shape[0])
    cls[:5] = [-1, -40, 40, 3, -2]
    packed1 = _packed1(X)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(pad_idx), jnp.asarray(cls), jnp.asarray(pol), jnp.asarray(packed1)))
    got = tms._local_plan_executor_clausemajor(
        torch.from_numpy(pad_idx), torch.from_numpy(cls), torch.from_numpy(pol),
        from_u32(packed1))
    assert np.array_equal(got.numpy(), want)


# -- the clause_table twin -------------------------------------------------


@pytest.mark.parametrize("lc_extra", [0, 3, 40])
def test_clause_table_twin_is_the_class_major_executor(case, lc_extra):
    """``clause_table`` on CPU tensors runs the twin (no launch), equal to
    the reference's clause-major executor on the same class-major table,
    across slot counts that straddle the twin's power-of-two padding."""
    cfg, acts, w, X, oracle, plans = case
    plan = plans["weighted"][0]
    C = int(plan.clauses_per_class(cfg.n_classes).max())
    Lc = int(plan.includes_per_clause().max()) + lc_extra
    idx, pol = tms.fill_clause_tables(plan, 4, C, Lc, 60)
    cls = np.repeat(np.arange(4, dtype=np.int32), C)
    packed1 = _packed1(X)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(idx.reshape(-1, Lc)), jnp.asarray(cls),
        jnp.asarray(pol.reshape(-1)), jnp.asarray(packed1)))[:4]
    before = ctk.launches
    args = (torch.from_numpy(idx), torch.from_numpy(pol), from_u32(packed1))
    got = clause_table(*args)
    assert ctk.launches == before
    assert torch.equal(got, clause_table_plain(*args))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["runs", "pad row", "wrap"])
def test_clause_table_twin_on_repeated_and_wrapped_slots(kind):
    """The twin equals the reference's clause-major executor on the slot
    patterns the kernel collapses: runs of a repeated row with pads among
    them and across slots 32 and 64, pads on a random row (not all ones),
    and ``-1`` beside ``n_rows - 1``."""
    rng = np.random.default_rng(5)
    M, C, lc, l2, w = 3, 9, 70, 40, 3
    idx = rng.integers(0, l2, (M, C, lc)).astype(np.int32)
    if kind == "runs":
        idx[rng.random(idx.shape) < 0.2] = l2
        repeat = rng.random(idx.shape) < 0.75
        for j in range(1, lc):
            idx[..., j] = np.where(repeat[..., j], idx[..., j - 1], idx[..., j])
        idx[:, :, 28:36] = idx[:, :, 28:29]
        idx[:, :, 60:70] = idx[:, :, 60:61]
    else:
        idx[:, :, 4:] = l2  # pads after four includes
        idx[0, 0, 1:5] = (-1, l2, -1, l2)
        idx[1, 2, 31:33] = (l2, -1)
    pol = rng.integers(-7, 8, (M, C)).astype(np.int32)
    words = [rng.integers(0, 2**32, (l2 + 1, w), dtype=np.uint64).astype(np.uint32)
             for _ in range(3)]
    packed1 = words[0] | words[1] | words[2]
    if kind == "runs":
        packed1[-1] = 0xFFFFFFFF
    cls = np.repeat(np.arange(M, dtype=np.int32), C)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(idx.reshape(-1, lc)), jnp.asarray(cls),
        jnp.asarray(pol.reshape(-1)), jnp.asarray(packed1)))[:M]
    got = clause_table(torch.from_numpy(idx), torch.from_numpy(pol), from_u32(packed1))
    assert np.abs(want).sum() > 0
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,C,W,aligned,vec,split", [
    (10, 200, 256, True, 4, 8),  # the served plan on one device
    (10, 128, 256, True, 4, 8),  # tm-paper on one device
    (5, 200, 128, True, 1, 8),  # the served plan's tile on a (2, 2) mesh
    (10, 200, 128, True, 1, 5),  # the served plan's tile on a (1, 2) mesh
    (5, 64, 128, True, 1, 4),  # tm-paper on a (2, 2) mesh: 64 rows, 4 blocks
    (64, 512, 1024, True, 1, 1),  # tm-xl: 2,048 tiles fill the card
    (10, 200, 256, False, 1, 2), (10, 200, 252, True, 4, 8),
    (10, 200, 250, True, 1, 2), (20, 50, 132, True, 4, 4),
    (1, 1000, 1, True, 1, 8), (2, 101, 3, True, 1, 7), (28, 200, 1, True, 1, 8),
    (29, 200, 1, True, 1, 7), (33, 17, 1, True, 1, 2), (112, 40, 1, True, 1, 2),
    (113, 40, 1, True, 1, 1), (224, 3, 4, True, 1, 1), (3, 0, 5, True, 1, 1),
    (0, 5, 8, True, 1, 1),
])
def test_clause_table_shape_fills_the_card(M, C, W, aligned, vec, split):
    """The launch's words per lane and blocks per tile: four words where
    the rows are 16-byte aligned and one-word tiles leave SMs idle while
    split four-word tiles do not; a tile split over as many blocks as
    stay resident (224), at most 8 (a portable cluster) and at most one
    per 16 rows of a class."""
    assert ctk.clause_table_shape(M, C, W, aligned) == (vec, split)
    tiles = M * -(-W // (32 * vec))
    assert split == 1 or tiles * split <= 224


def test_clause_table_checks_its_operands():
    idx = torch.zeros((2, 3, 4), dtype=torch.int32)
    pol = torch.zeros((2, 3), dtype=torch.int32)
    p1 = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        clause_table(idx.to(torch.int64), pol, p1)
    with pytest.raises(ValueError, match=r"pol \[M, C\]"):
        clause_table(idx, pol[:1], p1)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        clause_table(idx.to("meta"), pol.to("meta"), p1.to("meta"))
    assert torch.equal(clause_table(idx, pol, p1), torch.zeros((2, 64), dtype=torch.int32))


def test_pack_columns_is_pack_literals_of_the_literals():
    from repro_torch.core.tm import literals, pack_columns

    x = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (96, 7), dtype=np.uint8))
    assert torch.equal(pack_columns(literals(x)), pack_literals(x))
    want = pack_literals(x[:64])
    want[:, 1] &= 0xFF  # rows 40..63 (bits 8..31 of word 1) pack as 0
    assert torch.equal(pack_columns(literals(x[:40])), want)


# -- clause tables and operands ------------------------------------------------


@pytest.mark.parametrize("kind", ["weightless", "weighted"])
@pytest.mark.parametrize("Mp", [4, 6])
def test_clause_tables_from_one_program_are_equal(case, kind, Mp):
    """One ``TMProgram``'s bytes, written by the reference and read by
    the port, decode to the same clause tables in both packages."""
    cfg, acts, w, X, oracle, plans = case
    jplan = plans[kind][1]
    jmodel = jencode(JTMConfig(4, 10, 30), acts, w if kind == "weighted" else None)
    blob = JTMProgram(JCapacityPlan(), jmodel).to_bytes()
    plan = decode_to_plan(TMProgram.from_bytes(blob).model)
    C = int(plan.clauses_per_class(cfg.n_classes).max())
    Lc = int(plan.includes_per_clause().max())
    idx, pol = tms.fill_clause_tables(plan, Mp, C, Lc, 60)
    jidx, jpol = jtms.fill_clause_tables(jdecode_to_plan(jmodel), Mp, C, Lc, 60)
    assert np.array_equal(jtms.fill_clause_tables(jplan, Mp, C, Lc, 60)[0], jidx)
    assert np.array_equal(idx, jidx) and np.array_equal(pol, jpol)
    assert idx.dtype == jidx.dtype and pol.dtype == jpol.dtype


def test_operands_from_plan_match_the_reference_and_raise_at_capacity(case):
    cfg, acts, w, X, oracle, plans = case
    plan, jplan = plans["weighted"]
    C = int(plan.clauses_per_class(cfg.n_classes).max())
    Lc = int(plan.includes_per_clause().max())
    scfg = tms.TMShardedConfig("t", 4, C, 30, batch=64, include_cap=Lc)
    jscfg = jtms.TMShardedConfig("t", 4, C, 30, batch=64, include_cap=Lc)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jtms.operands_from_plan(jscfg, jplan, X, jmesh)
    got = tms.operands_from_plan(scfg, plan, X, shd.make_mesh((1, 1), devices="cpu"))
    for g, wnt in zip(got, want):
        assert g.device.type == "cpu"
        assert np.array_equal(g.numpy(), np.asarray(wnt))
        assert g.numpy().dtype == np.asarray(wnt).dtype
    # padded classes on a model axis of 3: Mp = 6
    idx3, pol3, _ = tms.operands_from_plan(scfg, plan, X, shd.make_mesh((1, 3), devices="cpu"))
    assert idx3.shape == (6, C, Lc) and not pol3[4:].any()
    for small in (dict(n_clauses=C - 1, include_cap=Lc), dict(n_clauses=C, include_cap=Lc - 1)):
        bad = tms.TMShardedConfig("t", 4, n_features=30, batch=64, **small)
        jbad = jtms.TMShardedConfig("t", 4, n_features=30, batch=64, **small)
        match = "clause capacity" if small["n_clauses"] < C else "includes; capacity"
        with pytest.raises(ValueError, match=match):
            tms.operands_from_plan(bad, plan, X, shd.make_mesh((1, 1), devices="cpu"))
        with pytest.raises(ValueError, match=match):
            jtms.operands_from_plan(jbad, jplan, X, jmesh)
    with pytest.raises(ValueError, match="batch 32 != configured 64"):
        tms.operands_from_plan(scfg, plan, X[:32], shd.make_mesh((1, 1), devices="cpu"))


def test_configs_match_the_reference():
    assert set(tms.TM_CONFIGS) == set(jtms.TM_CONFIGS) == {"tm-paper", "tm-xl"}
    for name, cfg in tms.TM_CONFIGS.items():
        jcfg = jtms.TM_CONFIGS[name]
        for f in ("n_classes", "n_clauses", "n_features", "batch", "lc_cap"):
            assert getattr(cfg, f) == getattr(jcfg, f)
    assert tms.TM_CONFIGS["tm-paper"].lc_cap == 160
    assert tms.TM_CONFIGS["tm-xl"].lc_cap == 328


# -- build_tm_sharded on CPU meshes -------------------------------------------


@pytest.mark.parametrize("shape", CPU_MESHES + [(1, 3), (3, 1)])
@pytest.mark.parametrize("kind", ["weightless", "weighted"])
def test_build_tm_sharded_matches_the_oracle_on_cpu_meshes(case, shape, kind):
    """Every tile of the class x batch split runs the twin on the CPU;
    the assembled sums equal the dense oracle (weightless) and the
    reference's clause-major executor on the same tables, padded class
    columns zero.  (1, 3) pads 4 classes to 6; (3, 1) leaves the batch of
    64 replicated (3 does not divide it)."""
    cfg, acts, w, X, oracle, plans = case
    plan, jplan = plans[kind]
    C = int(plan.clauses_per_class(cfg.n_classes).max())
    Lc = int(plan.includes_per_clause().max()) + 2
    scfg = tms.TMShardedConfig("t", 4, C, 30, batch=64, include_cap=Lc)
    mesh = shd.make_mesh(shape, devices="cpu")
    fn, specs = tms.build_tm_sharded(scfg, mesh)
    ops = tms.operands_from_plan(scfg, plan, X, mesh)
    for op, spec in zip(ops, specs):
        assert tuple(op.shape) == spec.shape and op.dtype == spec.dtype
    assert specs[0].spec == ("model", None, None)
    assert specs[2].spec == (shd.batch_axes(mesh, 64), None)
    sums = fn(*ops)
    assert sums.dtype == torch.int32 and tuple(sums.shape) == (64, fn.Mp)
    sums = sums.numpy()
    assert (sums[:, 4:] == 0).all()
    jidx, jpol = jtms.fill_clause_tables(jplan, 4, C, Lc, 60)
    want = np.asarray(jtms._local_plan_executor_clausemajor(
        jnp.asarray(jidx.reshape(-1, Lc)), jnp.asarray(np.repeat(np.arange(4), C)),
        jnp.asarray(jpol.reshape(-1)), jnp.asarray(_packed1(X))))[:4, :64].T
    assert np.array_equal(sums[:, :4], want)
    if kind == "weightless":
        assert np.array_equal(sums[:, :4], oracle)
    # the packed route over tables placed once gives the same sums
    tables = fn.place(ops[0], ops[1])
    packed1 = torch.cat([pack_literals(torch.from_numpy(X)),
                         torch.full((1, 2), -1, dtype=torch.int32)])
    assert np.array_equal(fn.packed(tables, packed1).numpy(), sums)


def test_build_tm_sharded_refuses_wrong_operands(case):
    cfg, acts, w, X, oracle, plans = case
    plan = plans["weightless"][0]
    Lc = int(plan.includes_per_clause().max())
    scfg = tms.TMShardedConfig("t", 4, 10, 30, batch=64, include_cap=Lc)
    mesh = shd.make_mesh((1, 2), devices="cpu")
    fn, _ = tms.build_tm_sharded(scfg, mesh)
    idx, pol, lits = tms.operands_from_plan(scfg, plan, X, mesh)
    with pytest.raises(ValueError, match="idx/pol shapes"):
        fn(idx[:2], pol[:2], lits)
    with pytest.raises(ValueError, match="lits shape"):
        fn(idx, pol, lits[:32])
    with pytest.raises(ValueError, match="packed1 must be"):
        fn.packed(fn.place(idx, pol), torch.zeros((60, 2), dtype=torch.int32))
