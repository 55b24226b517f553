"""Logical-axis sharding rules with divisibility fallback.

Every parameter / cache / activation dimension is assigned a *logical*
axis by pattern-matching its tree path and rank; rule tables map logical
axes onto mesh axes.  A mapping is dropped (replicated) whenever the
dimension size is not divisible by the mesh-axis product — e.g.
gemma-2b's 8 query heads cannot shard over a 16-way ``model`` axis, so
heads replicate while its 16384-wide d_ff and 256000 vocab shard.

Rule tables:
  TRAIN_RULES  — FSDP over ``data`` (embed dim) x TP over ``model``
                 (heads / mlp / vocab / experts); batch over (pod, data).
  SERVE_RULES  — pure TP for weights; batch over (pod, data); decode KV
                 sequence over ``model`` (flash-decode style partial
                 attention).

The port of ``repro/distributed/sharding.py``; the patterns, the rules
and ``spec_for`` are the reference's.  The mesh is a ``DeviceMesh``,
whose sizes are read from its ``mesh_dim_names`` and ``shape``, and a
spec is the port's own ``PartitionSpec``: a tuple whose entries are
``None``, a mesh axis or a tuple of mesh axes (major to minor), trailing
``None``s stripped, entry for entry JAX's.

Per-layer lists.  The reference stacks a model's per-layer parameter
dicts along a leading axis (its path string ``layers/attn/wq``, rank 4);
the port keeps a list of per-layer dicts (``layers/[3]/attn/wq``, rank
3).  A leaf's path string drops the list indices and its rank counts
them back in, so the patterns see exactly what they see in the
reference; the logical axes of those leading list levels ("layers", or
``None`` where no pattern matched) are then dropped.  A per-layer
tensor's spec is therefore the reference's spec of the stacked tensor
without its leading entry, which both rule tables replicate.
``tree_shardings`` also gives each leaf's DTensor placements, and
``distribute`` places a tree by them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

LogicalAxes = Tuple[Optional[str], ...]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, major to
    minor).  ``PartitionSpec(*entries)``, as JAX's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A leaf's placement: the mesh, its spec, and the DTensor placements
    (one ``Shard(dim)`` or ``Replicate()`` per mesh dimension)."""
    mesh: DeviceMesh
    spec: PartitionSpec
    placements: Tuple[Placement, ...]


# --------------------------------------------------------------------- #
# Logical axis assignment by leaf path
# --------------------------------------------------------------------- #
_PARAM_PATTERNS = [
    # (path substring, rank -> logical axes); first match wins.
    # The embedding table's d_model dim is deliberately NOT FSDP-sharded
    # ("emb_d" -> None): sharding the unembed contraction dim over the
    # same axis as the batch would gather full-batch logits on every
    # chip — replicating the small table is free.
    ("embed/tok",      {2: ("vocab", "emb_d")}),
    ("embed/unembed",  {2: ("emb_d", "vocab")}),
    ("wq",             {3: ("embed", "heads", None),
                        4: ("layers", "embed", "heads", None)}),
    ("wk",             {3: ("embed", "kv_heads", None),
                        4: ("layers", "embed", "kv_heads", None)}),
    ("wv",             {3: ("embed", "kv_heads", None),
                        4: ("layers", "embed", "kv_heads", None)}),
    ("wo",             {3: ("heads", None, "embed"),
                        4: ("layers", "heads", None, "embed")}),
    ("bq",             {2: ("heads", None), 3: ("layers", "heads", None)}),
    ("bk",             {2: ("kv_heads", None),
                        3: ("layers", "kv_heads", None)}),
    ("bv",             {2: ("kv_heads", None),
                        3: ("layers", "kv_heads", None)}),
    ("router",         {2: ("embed", "expert"),
                        3: ("layers", "embed", "expert")}),
    ("w_gate",         {2: ("embed", "mlp"),
                        3: ("layers", "embed", "mlp"),
                        4: ("layers", "expert", "embed", "mlp")}),
    ("w_up",           {2: ("embed", "mlp"),
                        3: ("layers", "embed", "mlp"),
                        4: ("layers", "expert", "embed", "mlp")}),
    ("w_down",         {2: ("mlp", "embed"),
                        3: ("layers", "mlp", "embed"),
                        4: ("layers", "expert", "mlp", "embed")}),
    # mamba2
    ("in_proj",        {2: ("embed", "mamba_proj"),
                        3: ("layers", "embed", "mamba_proj")}),
    ("out_proj",       {2: ("mamba_inner", "embed"),
                        3: ("layers", "mamba_inner", "embed")}),
    ("conv_w",         {2: (None, "mamba_proj"),
                        3: ("layers", None, "mamba_proj")}),
    # rwkv6
    ("w_lora_a",       {2: ("embed", None), 3: ("layers", "embed", None)}),
    ("w_lora_b",       {2: (None, "embed"), 3: ("layers", None, "embed")}),
    ("w_r",            {2: ("embed", "rwkv_inner"),
                        3: ("layers", "embed", "rwkv_inner")}),
    ("w_k",            {2: ("embed", "rwkv_inner"),
                        3: ("layers", "embed", "rwkv_inner")}),
    ("w_v",            {2: ("embed", "rwkv_inner"),
                        3: ("layers", "embed", "rwkv_inner")}),
    ("w_g",            {2: ("embed", "rwkv_inner"),
                        3: ("layers", "embed", "rwkv_inner")}),
    ("w_o",            {2: ("rwkv_inner", "embed"),
                        3: ("layers", "rwkv_inner", "embed")}),
    ("ck",             {2: ("embed", "mlp"),
                        3: ("layers", "embed", "mlp")}),
    ("cv",             {2: ("mlp", "embed"),
                        3: ("layers", "mlp", "embed")}),
    ("cr",             {2: ("embed", "rwkv_inner"),
                        3: ("layers", "embed", "rwkv_inner")}),
]


def _leaf_axes(path: str, ndim: int) -> LogicalAxes:
    for pat, by_rank in _PARAM_PATTERNS:
        if pat in path and ndim in by_rank:
            return by_rank[ndim]
    return (None,) * ndim       # norms, biases, scalars: replicate


def leaf_path(path) -> Tuple[str, int]:
    """A leaf's path string as the reference builds it, and the number
    of per-layer list levels above the leaf.  ``path`` is a key path of
    ``torch.utils._pytree.tree_flatten_with_path``; list indices are
    dropped from the string (the reference stacks those lists)."""
    keys = [k for k in path if not isinstance(k, pytree.SequenceKey)]
    return ("/".join(str(getattr(k, "key", k)) for k in keys),
            len(path) - len(keys))


def _is_axes(x) -> bool:
    return type(x) is tuple


def _logical_tree(tree: Any, axes_of) -> Any:
    """``axes_of(path string, stacked rank)`` for each leaf of ``tree``,
    with the logical axes of its per-layer list levels dropped."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        spath, depth = leaf_path(path)
        nd = leaf.ndim if hasattr(leaf, "ndim") else 0
        axes = axes_of(spath, nd + depth)
        if any(a not in (None, "layers") for a in axes[:depth]):
            raise ValueError(f"{spath}: list level with logical axes "
                             f"{axes[:depth]}")
        out.append(tuple(axes[depth:]))
    return pytree.tree_unflatten(out, spec)


def param_logical_axes(params: Any) -> Any:
    """Tree of logical-axes tuples matching the parameter tree."""
    return _logical_tree(params, _leaf_axes)


# --------------------------------------------------------------------- #
# Rule tables: logical axis -> mesh axis (or tuple of mesh axes)
# --------------------------------------------------------------------- #
TRAIN_RULES: Dict[str, Any] = {
    "embed": "data",            # FSDP shard of the contraction dim
    "emb_d": None,              # embed table d_model: replicate (see above)
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "mamba_proj": "model",
    "mamba_inner": "model",
    "rwkv_inner": "model",
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
}

SERVE_RULES: Dict[str, Any] = {
    "embed": None,              # weights replicated across data (TP only)
    "emb_d": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "mamba_proj": "model",
    "mamba_inner": "model",
    "rwkv_inner": "model",
    "layers": None,
    "batch": ("pod", "data"),
    "seq": ("pod", "data"),     # long-context prefill: sequence parallel
    # decode: flash-decode style KV split over whatever batch left free
    "kv_seq": ("data", "model"),
}


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order."""
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh has no axis names")
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _mesh_axes_for(shape: Dict[str, int],
                   rule) -> Tuple[Tuple[str, ...], int]:
    """The mesh axes of ``rule`` that a mesh of axis sizes ``shape``
    (``mesh_shape``) has, and their product."""
    if rule is None:
        return (), 1
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    axes = tuple(a for a in axes if a in shape)
    size = 1
    for a in axes:
        size *= shape[a]
    return axes, size


def spec_for(shape: Sequence[int], logical: LogicalAxes, mesh: DeviceMesh,
             rules: Dict[str, Any]) -> PartitionSpec:
    """PartitionSpec with divisibility fallback to replication.

    Mesh axes already claimed by an earlier dimension of the same tensor
    are dropped from later rules (e.g. decode KV: batch takes (pod, data),
    kv_seq then maps onto the remaining model axis).  Rules whose full
    remaining product does not divide the dimension fall back to the
    largest dividing prefix, else replication.
    """
    return _spec_for(shape, logical, mesh_shape(mesh), rules)


def _spec_for(shape: Sequence[int], logical: LogicalAxes,
              sizes: Dict[str, int], rules: Dict[str, Any]) -> PartitionSpec:
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        if name is None:
            parts.append(None)
            continue
        rule = rules.get(name)
        axes, _ = _mesh_axes_for(sizes, rule)
        axes = tuple(a for a in axes if a not in used)
        # largest prefix of axes whose product divides dim
        chosen: Tuple[str, ...] = ()
        size = 1
        for a in axes:
            nxt = size * sizes[a]
            if dim % nxt == 0:
                chosen = chosen + (a,)
                size = nxt
        if not chosen or size <= 1:
            parts.append(None)
            continue
        used.update(chosen)
        parts.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def placements_for(spec: PartitionSpec,
                   mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``: mesh dim i is ``Shard(d)`` where
    tensor dim d's entry names mesh axis i, else ``Replicate()``.  A dim
    sharded over several axes takes them major to minor, which DTensor
    does in mesh-dim order: their order in the entry must be the mesh's
    (it is in both rule tables), else this raises."""
    return _placements_for(spec, list(mesh_shape(mesh)))


def _placements_for(spec: PartitionSpec,
                    names: list) -> Tuple[Placement, ...]:
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(tree_avals: Any, logical_tree: Any, mesh: DeviceMesh,
                   rules: Dict[str, Any]) -> Any:
    """``NamedSharding`` (mesh, spec, placements) tree for a tree of
    tensors (any device, ``meta`` too) and its logical-axes tree."""
    leaves, spec = pytree.tree_flatten(tree_avals)
    logical, lspec = pytree.tree_flatten(logical_tree, is_leaf=_is_axes)
    if lspec != spec:
        raise ValueError("the logical-axes tree does not match the tree")
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = []
    for leaf, axes in zip(leaves, logical):
        s = _spec_for(leaf.shape, axes, sizes, rules)
        out.append(NamedSharding(mesh, s, _placements_for(s, names)))
    return pytree.tree_unflatten(out, spec)


def distribute(tree: Any, shardings: Any, *,
               src_data_rank: Optional[int] = 0) -> Any:
    """``tree``'s tensors as DTensors placed by ``shardings`` (a
    ``tree_shardings`` tree): ``distribute_tensor`` with each leaf's
    placements, the values of rank ``src_data_rank`` (None: each rank's
    own, no collective)."""
    from torch.distributed.tensor import distribute_tensor
    leaves, spec = pytree.tree_flatten(tree)
    shs = pytree.tree_leaves(shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding))
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(shs)} shardings")
    return pytree.tree_unflatten(
        [distribute_tensor(t, s.mesh, s.placements,
                           src_data_rank=src_data_rank)
         for t, s in zip(leaves, shs)], spec)


def param_shardings(params_avals: Any, mesh: DeviceMesh,
                    rules: Dict[str, Any]) -> Any:
    if rules.get("layers") is not None:
        raise ValueError("the port keeps per-layer lists: the layers axis "
                         "cannot shard")
    return tree_shardings(params_avals, param_logical_axes(params_avals),
                          mesh, rules)


# --------------------------------------------------------------------- #
# Cache / batch logical axes
# --------------------------------------------------------------------- #
def _cache_axes(spath: str, nd: int) -> LogicalAxes:
    if ("kv" in spath or "cross" in spath) and nd == 5:
        return ("layers", "batch", "kv_seq", "kv_heads", None)
    if nd >= 2:
        return ("layers", "batch") + (None,) * (nd - 2)
    return (None,) * nd


def cache_logical_axes(cache: Any) -> Any:
    """KV caches: (L, B, T, H, D) -> (layers, batch, kv_seq, kv_heads, _);
    SSM states: (L, B, ...) -> batch-sharded only."""
    return _logical_tree(cache, _cache_axes)


def batch_logical_axes(batch_tree: Any, seq_axis: bool = True) -> Any:
    def one(leaf):
        nd = leaf.ndim
        if nd == 0:
            return ()
        if nd == 1:
            return ("batch",)
        return ("batch", "seq" if seq_axis else None) + \
            (None,) * (nd - 2)
    return pytree.tree_map(one, batch_tree)
