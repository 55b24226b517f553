"""The port's sharding layer (``distributed/{context,sharding}.py``,
``launch/mesh.py``) against the JAX package's.

  * path strings: every leaf of every config's parameters and optimizer
    state, built by the reference's join over the port's tree, names a
    leaf of the reference's tree (list indices dropped: the reference
    stacks the per-layer dicts), at the stacked shape;
  * specs: for every defined (arch x shape) cell, its parameters,
    optimizer state or cache, and batch from ``launch/steps.py``'s
    ``input_specs`` (``meta``), on the (16, 16), (2, 16, 16), (2, 2) and
    (4, 2) meshes under both rule tables, each leaf's spec equals the
    reference's entry for entry (a per-layer leaf's without the stacked
    leading entry, which both tables replicate), and its placements are
    the spec's.  Port side: one subprocess that builds each mesh over a
    fake process group of its size and destroys the group after; the
    reference side: ``AbstractMesh`` in this process;
  * the fallbacks: gemma-2b's 8 heads on a 16-way model axis, decode
    KV's ``kv_seq`` after the batch, ``long_500k``'s batch of 1;
  * placements on a 4-rank gloo (2, 2) mesh: each rank's
    ``distribute_tensor`` block of the smoke gpt-oss-20b and llama3-8b
    parameters equals, bit for bit, the reference's shard on the JAX
    host device at the same mesh coordinate (4 host devices);
  * ``mesh_context`` restores the previous mesh; meshes refuse a size
    other than the world's and a missing group; no process group is left
    initialised in the pytest worker.

Everything that initialises a process group or a multi-device JAX
backend runs in a subprocess (``_torch_dist.run``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro_torch.distributed import context as TCTX  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from _torch_dist import result, run  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
RULES = ("TRAIN_RULES", "SERVE_RULES")
CELLS = [(a, s) for a in TC.ARCHS for s in SHAPES
         if TS.cell_is_defined(a, s)[0]]
GLOO_ARCHS = ("gpt_oss_20b", "llama3_8b")


def _jpath(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def _trees(specs, kind, sh):
    """(name, tree, logical tree) of a cell's step arguments in package
    ``sh``: parameters, then optimizer state (train) or cache, then the
    batch with and without its sequence axis."""
    params, state, batch = specs
    state_axes = sh.param_logical_axes(state) if kind == "train" \
        else sh.cache_logical_axes(state)
    return [("params", params, sh.param_logical_axes(params)),
            ("state", state, state_axes),
            ("batch", batch, sh.batch_logical_axes(batch)),
            ("batch_noseq", batch, sh.batch_logical_axes(batch,
                                                         seq_axis=False))]


def port_spec_table() -> dict:
    """Run in a subprocess: {(mesh, rules, arch, shape, tree): {port path
    string: (spec, placements, list depth)}} over fake groups, and the
    mesh facts the tests read."""
    from torch.distributed.tensor import Shard
    from _torch_dist import checks
    trees, paths = {}, {}
    for cell in CELLS:
        trees[cell] = _trees(TS.input_specs(TS.get_cell(*cell)),
                             TS.get_cell(*cell).step_kind, TSH)
        for tname, tree, _ in trees[cell]:
            paths[cell + (tname,)] = [
                (_jpath(p), TSH.leaf_path(p)[1])
                for p, _ in pytree.tree_flatten_with_path(tree)[0]]
    table, facts = {}, {}

    def place(pl):
        return tuple(f"S{p.dim}" if isinstance(p, Shard) else "R"
                     for p in pl)
    for mname, (shape, names) in MESHES.items():
        with TMESH.fake_world(int(np.prod(shape))):
            mesh = TMESH.make_mesh(shape, names, device_type="cpu")
            facts[mname] = (mesh.mesh_dim_names, tuple(mesh.shape),
                            mesh.size())
            for rname in RULES:
                rules = getattr(TSH, rname)
                for cell in CELLS:
                    for tname, tree, axes in trees[cell]:
                        shd = pytree.tree_leaves(
                            TSH.tree_shardings(tree, axes, mesh, rules),
                            is_leaf=lambda x: isinstance(
                                x, TSH.NamedSharding))
                        table[(mname, rname) + cell + (tname,)] = {
                            p: (tuple(s.spec), place(s.placements), depth)
                            for (p, depth), s in zip(
                                paths[cell + (tname,)], shd)}
        facts[mname + "_after"] = dist.is_initialized()

    def production():
        out = {}
        for multi, n in ((False, 256), (True, 512)):
            with TMESH.fake_world(n):
                m = TMESH.make_production_mesh(multi_pod=multi,
                                               device_type="cpu")
                out[multi] = (m.mesh_dim_names, tuple(m.shape))
        return out

    def mismatch():
        with TMESH.fake_world(8):
            with pytest.raises(ValueError, match="needs 4 ranks"):
                TMESH.make_mesh((2, 2), ("data", "model"),
                                device_type="cpu")
            with pytest.raises(RuntimeError, match="already"):
                with TMESH.fake_world(8):
                    pass

    def order():
        with TMESH.fake_world(4):
            mesh = TMESH.make_mesh((2, 2), ("data", "model"),
                                   device_type="cpu")
            with pytest.raises(ValueError, match="mesh's order"):
                TSH.placements_for(TSH.P(("model", "data")), mesh)
            with pytest.raises(ValueError, match="layers axis"):
                TSH.param_shardings({}, mesh, {"layers": "data"})
            return place(TSH.placements_for(
                TSH.P(None, ("data", "model")), mesh))

    def fake_import():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        return FakeStore.__name__
    facts.update(checks([("production", production),
                         ("mismatch", mismatch), ("order", order),
                         ("fake_import", fake_import)]))
    facts["initialized_at_exit"] = dist.is_initialized()
    return {"table": table, "facts": facts}


@pytest.fixture(scope="module")
def port_specs():
    return run("""
    from _torch_dist import save
    import test_torch_sharding as T
    save(OUT, T.port_spec_table())
    """, timeout=600)


@functools.lru_cache(maxsize=None)
def _jax_specs(cell):
    return JS.input_specs(JS.get_cell(*cell))


@functools.lru_cache(maxsize=None)
def _port_meta_specs(cell):
    return TS.input_specs(TS.get_cell(*cell))


def _jax_table(mname, rname, cell, tname) -> dict:
    shape, names = MESHES[mname]
    mesh = AbstractMesh(shape, names)
    kind = JS.get_cell(*cell).step_kind
    _, tree, axes = next(t for t in _trees(_jax_specs(cell), kind, JSH)
                         if t[0] == tname)
    shd = JSH.tree_shardings(tree, axes, mesh, getattr(JSH, rname))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shd, is_leaf=lambda x: hasattr(x, "spec"))
    return {_jpath(p): tuple(s.spec) for p, s in flat}


def _stacked(path: str) -> str:
    """The reference's path of a port leaf: list indices dropped."""
    return "/".join(c for c in path.split("/") if not c.startswith("["))


def _placements(spec, names) -> tuple:
    """What the spec's placements must be: mesh axis i sharded on the dim
    whose entry names it."""
    out = ["R"] * len(names)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else e or ()):
            out[names.index(a)] = f"S{d}"
    return tuple(out)


# --------------------------------------------------------------------- #
# Path strings
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_path_strings_equal_jax(arch):
    """Every port leaf of the parameters and the AdamW state names a
    reference leaf: list indices dropped, the stacked shape equal; and
    every reference leaf is named."""
    cell = (arch, "train_4k")
    jparams, jopt, _ = _jax_specs(cell)
    tparams, topt, _ = _port_meta_specs(cell)
    for jtree, ttree in ((jparams, tparams), (jopt, topt)):
        jflat, _ = jax.tree_util.tree_flatten_with_path(jtree)
        want = {_jpath(p): tuple(leaf.shape) for p, leaf in jflat}
        tflat, _ = pytree.tree_flatten_with_path(ttree)
        stacked = {}
        for path, leaf in tflat:
            spath, depth = TSH.leaf_path(path)
            assert spath in want, spath
            assert depth in (0, 1), spath
            if depth:
                n = len(stacked.setdefault(spath, []))
                assert _jpath(path).replace(f"/[{n}]/", "/") == spath
                stacked[spath].append(tuple(leaf.shape))
            else:
                assert tuple(leaf.shape) == want[spath], spath
        for spath, shapes in stacked.items():
            assert len(set(shapes)) == 1, spath
            assert (len(shapes),) + shapes[0] == want[spath], spath
        assert {TSH.leaf_path(p)[0] for p, _ in tflat} == set(want)


# --------------------------------------------------------------------- #
# Specs of every cell on the four meshes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rname", RULES)
@pytest.mark.parametrize("mname", list(MESHES))
def test_specs_equal_jax(port_specs, mname, rname):
    table = port_specs["table"]
    names = list(MESHES[mname][1])
    n = 0
    for cell in CELLS:
        for tname in ("params", "state", "batch", "batch_noseq"):
            want = _jax_table(mname, rname, cell, tname)
            got = table[(mname, rname) + cell + (tname,)]
            seen = set()
            for path, (spec, placements, depth) in got.items():
                jpath = _stacked(path)
                seen.add(jpath)
                ref = want[jpath]
                where = (mname, rname, cell, path)
                # the stacked leading entry: replicated in both tables
                assert all(e is None for e in ref[:depth]), (where, ref)
                assert spec == ref[depth:], (where, spec, ref)
                assert placements == _placements(spec, names), where
                n += 1
            assert seen == set(want), (cell, tname)
    assert n > 20000


def test_mesh_facts(port_specs):
    facts = port_specs["facts"]
    for mname, (shape, names) in MESHES.items():
        assert facts[mname] == (names, shape, int(np.prod(shape)))
        assert facts[mname + "_after"] is False
    assert result(facts, "production") == {
        False: (("data", "model"), (16, 16)),
        True: (("pod", "data", "model"), (2, 16, 16))}
    result(facts, "mismatch")
    assert result(facts, "order") == ("S1", "S1")
    assert result(facts, "fake_import") == "FakeStore"
    assert facts["initialized_at_exit"] is False


# (case, mesh, rules, cell, tree, port leaf, port spec, its placements)
FALLBACKS = [
    # gemma-2b's one KV head cannot shard 16 ways: replicated when
    # serving, only the FSDP embed dim under TRAIN_RULES; its 8 query
    # heads, padded to 16 (config.padded_heads), and its 16384-wide d_ff
    # shard
    ("gemma_kv_heads_serve", "SERVE_RULES", ("gemma_2b", "decode_32k"),
     "params", "layers/[0]/attn/wk", (), ("R", "R")),
    ("gemma_kv_heads_train", "TRAIN_RULES", ("gemma_2b", "train_4k"),
     "params", "layers/[0]/attn/wk", ("data",), ("S0", "R")),
    ("gemma_padded_heads_serve", "SERVE_RULES", ("gemma_2b", "decode_32k"),
     "params", "layers/[0]/attn/wq", (None, "model"), ("R", "S1")),
    ("gemma_mlp_serve", "SERVE_RULES", ("gemma_2b", "decode_32k"),
     "params", "layers/[0]/mlp/w_gate", (None, "model"), ("R", "S1")),
    # batch 128 takes data; kv_seq then takes the model axis left
    ("decode_kv_seq", "SERVE_RULES", ("llama3_8b", "decode_32k"), "state",
     "kv/k", (None, "data", "model"), ("S1", "S2")),
    # batch 1 cannot shard: kv_seq takes both axes, major to minor
    ("long_500k_kv", "SERVE_RULES", ("gpt_oss_20b", "long_500k"), "state",
     "kv/k", (None, None, ("data", "model")), ("S2", "S2")),
    ("long_500k_tokens", "SERVE_RULES", ("gpt_oss_20b", "long_500k"),
     "batch", "tokens", (), ("R", "R")),
]


@pytest.mark.parametrize("case", FALLBACKS, ids=[c[0] for c in FALLBACKS])
def test_named_fallbacks(port_specs, case):
    """The module docstrings' fallbacks on the (16, 16) mesh, in both
    packages."""
    _, rname, cell, tname, path, spec, placements = case
    got = port_specs["table"][("16x16", rname) + cell + (tname,)][path]
    assert got[:2] == (spec, placements)
    ref = _jax_table("16x16", rname, cell, tname)[_stacked(path)]
    assert ref[got[2]:] == spec


# --------------------------------------------------------------------- #
# Placements on four gloo ranks against JAX's shards on four devices
# --------------------------------------------------------------------- #
def port_blocks(rank, world, params_file):
    """One gloo rank: its ``distribute_tensor`` block of every parameter
    under both rule tables, and its mesh coordinate."""
    import pickle
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import convert
    with open(params_file, "rb") as f:
        jparams = pickle.load(f)
    mesh = TMESH.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    for arch, tree in jparams.items():
        params = convert.params_from_jax(tree, device="cpu")
        for rname in RULES:
            shd = TSH.param_shardings(params, mesh, getattr(TSH, rname))
            leaves, _ = pytree.tree_flatten_with_path(params)
            for (path, t), s in zip(leaves, pytree.tree_leaves(
                    shd, is_leaf=lambda x: isinstance(x,
                                                      TSH.NamedSharding))):
                local = distribute_tensor(t, mesh, s.placements).to_local()
                out[(arch, rname, _jpath(path))] = \
                    local.view(torch.int16).numpy().copy() \
                    if local.dtype == torch.bfloat16 else local.numpy().copy()
    return tuple(mesh.get_coordinate()), out


def jax_shards_and_port_blocks() -> dict:
    """Run in a subprocess with 4 JAX host devices: the reference's
    shards by mesh coordinate, and each gloo rank's blocks."""
    import os
    import tempfile
    from repro.launch.mesh import make_mesh
    from repro.models import model as JM
    from _torch_dist import gloo_world, save
    assert len(jax.devices()) == 4
    mesh = make_mesh((2, 2), ("data", "model"))
    coord = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    params = {a: jax.tree_util.tree_map(
        np.asarray, JM.init_params(JC.get_smoke(a), jax.random.PRNGKey(0)))
        for a in GLOO_ARCHS}
    ref, shapes = {}, {}
    for arch, tree in params.items():
        for rname in RULES:
            shd = JSH.param_shardings(tree, mesh, getattr(JSH, rname))
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            for (path, leaf), s in zip(flat, jax.tree_util.tree_leaves(
                    shd, is_leaf=lambda x: hasattr(x, "spec"))):
                arr = jax.device_put(leaf, s)
                shapes[(arch, _jpath(path))] = tuple(leaf.shape)
                for shard in arr.addressable_shards:
                    data = np.asarray(shard.data)
                    if data.dtype.itemsize == 2 and data.dtype != np.int16:
                        data = data.view(np.int16)
                    ref[(arch, rname, _jpath(path),
                         coord[shard.device])] = data
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "params.pkl")
        save(f, params)
        ranks = gloo_world(port_blocks, 4, f)
    return {"ref": ref, "shapes": shapes, "ranks": ranks,
            "initialized": dist.is_initialized()}


@pytest.fixture(scope="module")
def gloo_blocks():
    return run("""
    from _torch_dist import save
    import test_torch_sharding as T
    save(OUT, T.jax_shards_and_port_blocks())
    """, jax_devices=4, timeout=600)


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_gloo_placements_match_jax_shards(gloo_blocks, arch):
    ref, ranks = gloo_blocks["ref"], gloo_blocks["ranks"]
    assert sorted(c for c, _ in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    n_sharded = 0
    for coord, blocks in ranks:
        mine = {k: v for k, v in blocks.items() if k[0] == arch}
        assert len(mine) > 10
        for (a, rname, path), block in mine.items():
            index = [c for c in path.split("/") if c.startswith("[")]
            layer = int(index[0][1:-1]) if index else None
            path = _stacked(path)
            want = ref[(a, rname, path, coord)]
            if layer is not None:
                want = want[layer]
            assert block.dtype == want.dtype, (rname, path)
            assert np.array_equal(block, want), (coord, rname, path)
            full = gloo_blocks["shapes"][(a, path)]
            n_sharded += block.shape != full[0 if layer is None else 1:]
    assert n_sharded > 0
    assert gloo_blocks["initialized"] is False


# --------------------------------------------------------------------- #
# In this process: no group, and the context
# --------------------------------------------------------------------- #
def test_mesh_context_restores_the_previous_mesh():
    a, b = object(), object()
    assert TCTX.current_mesh() is None
    with TCTX.mesh_context(a):
        with TCTX.mesh_context(b):
            assert TCTX.current_mesh() is b
        assert TCTX.current_mesh() is a
        with pytest.raises(KeyError):
            with TCTX.mesh_context(b):
                raise KeyError
        assert TCTX.current_mesh() is a
    assert TCTX.current_mesh() is None


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    for make in (lambda: TMESH.make_production_mesh(device_type="cpu"),
                 lambda: TMESH.make_mesh((1, 1), ("data", "model"),
                                         device_type="cpu"),
                 lambda: TMESH.host_device_mesh(device_type="cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            make()
    with pytest.raises(ValueError, match="differ in length"):
        TMESH.make_mesh((2, 2), ("data",), device_type="cpu")


def test_partition_spec_is_a_tuple_of_entries():
    s = TSH.P("data", None, ("pod", "model"))
    assert s == ("data", None, ("pod", "model")) and len(s) == 3
    assert TSH.spec_for((8, 3), ("batch", None), _FakeMesh(), {
        "batch": ("pod", "data")}) == ("data",)
    assert TSH.P() == ()


class _FakeMesh:
    """What ``spec_for`` reads of a mesh: its axis names and sizes."""
    mesh_dim_names = ("data", "model")
    shape = (4, 2)


def test_unpadded_gemma_heads_replicate():
    """gemma-2b's 8 query heads as published (unpadded) cannot shard over
    a 16-way model axis: the whole tensor replicates when serving."""
    mesh = _FakeMesh()
    mesh.shape = (16, 16)
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    wq = TSH._leaf_axes("layers/attn/wq", 3)
    for rname, want in (("SERVE_RULES", ()), ("TRAIN_RULES", ("data",))):
        got = TSH.spec_for((2048, 8, 256), wq, mesh, getattr(TSH, rname))
        ref = JSH.spec_for((2048, 8, 256), wq, jmesh, getattr(JSH, rname))
        assert got == tuple(ref) == want


def test_no_process_group_left_in_the_worker():
    """Runs last in this file: the subprocesses' groups never reached
    this process."""
    assert not dist.is_initialized()
