"""Kernel analyzer: ``torch.export`` ATen graph -> KernelGraph.

The PyTorch counterpart of ``repro/core/analyzer.py`` and of the paper's
PTX-instrumentation analyzer (§III-A).  ``torch.export`` traces the step
on fake tensors into an ATen graph whose nodes carry their shapes and
dtypes (``node.meta["val"]``), so every kernel's FLOPs and bytes and
every edge's transfer size come from the trace, with no run.

The trace keeps the step's in-place writes (a KV cache row written with
``index_put_``, a recurrent state replaced by ``copy_`` or by the WKV/SSD
ops), so unlike a jaxpr it is not SSA: later nodes read the written
storage through views.  The dependencies are therefore the paper's
buffer read/write sets: each node's writes come from its op schema
(``alias_info.is_write``), views and in-place results alias the storage
of their input, and an edge runs from every writer of a storage to each
later reader (RAW), from each reader to the next writer (WAR), and
between writers (WAW), besides the value edges.

Each node is named by the reference's class of the operation (matmuls
``dot_general``, the attention kernels ``flash_attention``, the grouped
matmul ``ragged_dot``, the recurrences ``scan``, elementwise ops their
jaxpr names), so the cost model and the fusion pass are the reference's
unchanged; the ATen target stays in ``TracedGraph.targets``.  A kernel
costs what the reference's jnp ops cost for the same call (the JAX decode
step runs no Pallas kernel).  Tags come from ``marker`` regions.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.fx as fx
import torch.fx.traceback as fx_traceback
import torch.utils._pytree as pytree

from repro_torch.core.costmodel import _MXU_PRIMS
from repro_torch.core.graph import KernelGraph, KernelNode
from repro_torch.core.marker import tags_of

# --------------------------------------------------------------------- #
# Operation classes
# --------------------------------------------------------------------- #
# the kernels of the port, by the reference's class of the computation
KERNEL_CLASS = {"flash_decode": "flash_attention",
                "flash_prefill": "flash_attention",
                "gmm": "ragged_dot", "wkv": "scan", "ssd": "scan"}

# ATen op (overload packet name) -> jaxpr primitive name
_JAXPR_NAME = {
    "mm": "dot_general", "bmm": "dot_general", "matmul": "dot_general",
    "addmm": "dot_general", "baddbmm": "dot_general", "einsum":
    "dot_general", "linear": "dot_general",
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "flatten": "reshape", "expand": "broadcast_in_dim",
    "select": "slice", "slice": "slice", "narrow": "slice",
    "unsqueeze": "expand_dims", "squeeze": "squeeze",
    "permute": "transpose", "transpose": "transpose", "t": "transpose",
    "chunk": "split", "split": "split", "split_with_sizes": "split",
    "unbind": "split", "cat": "concatenate", "stack": "concatenate",
    "_to_copy": "convert_element_type", "to": "convert_element_type",
    "type_as": "convert_element_type", "clone": "copy",
    "contiguous": "copy", "alias": "copy", "detach": "copy",
    "lift_fresh_copy": "copy",
    "index_select": "gather", "index": "gather", "gather": "gather",
    "embedding": "gather",
    "index_put_": "scatter", "index_put": "scatter",
    "scatter_": "scatter", "scatter": "scatter",
    "scatter_add_": "scatter-add", "scatter_add": "scatter-add",
    "copy_": "dynamic_update_slice", "fill_": "dynamic_update_slice",
    "arange": "iota", "zeros": "broadcast_in_dim",
    "ones": "broadcast_in_dim", "full": "broadcast_in_dim",
    "empty": "broadcast_in_dim", "zeros_like": "broadcast_in_dim",
    "ones_like": "broadcast_in_dim", "full_like": "broadcast_in_dim",
    "empty_like": "broadcast_in_dim", "new_zeros": "broadcast_in_dim",
    "new_ones": "broadcast_in_dim", "new_full": "broadcast_in_dim",
    "new_empty": "broadcast_in_dim", "scalar_tensor": "broadcast_in_dim",
    "add": "add", "add_": "add", "sub": "sub", "rsub": "sub",
    "mul": "mul", "mul_": "mul", "div": "div", "div_": "div",
    "floor_divide": "div", "remainder": "rem", "fmod": "rem",
    "neg": "neg", "exp": "exp", "log": "log", "tanh": "tanh",
    "sigmoid": "logistic", "silu": "logistic", "softplus": "log",
    "gelu": "tanh", "relu": "max", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "reciprocal": "div", "pow": "pow", "square": "integer_pow",
    "abs": "abs", "sign": "sign", "floor": "floor", "ceil": "ceil",
    "cos": "cos", "sin": "sin", "erf": "erf",
    "maximum": "max", "minimum": "min", "clamp": "clamp",
    "clamp_min": "max", "clamp_max": "min",
    "where": "select_n", "masked_fill": "select_n",
    "masked_fill_": "select_n",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt",
    "ge": "ge", "logical_and": "and", "bitwise_and": "and",
    "logical_or": "or", "bitwise_or": "or", "logical_not": "not",
    "bitwise_not": "not", "isfinite": "is_finite",
    "sum": "reduce_sum", "mean": "reduce_sum", "var_mean": "reduce_sum",
    "var": "reduce_sum", "amax": "reduce_max", "max": "reduce_max",
    "amin": "reduce_min", "min": "reduce_min", "prod": "reduce_prod",
    "argmax": "argmax", "argmin": "argmin",
    "cumsum": "cumsum", "cumprod": "cumprod",
    "sort": "sort", "argsort": "sort", "topk": "top_k",
    "softmax": "exp", "_softmax": "exp", "log_softmax": "exp",
    "tril": "select_n", "triu": "select_n",
}

# Elementwise transcendental cost multipliers (flops per element), the
# reference's table.
_EW_COST = {
    "exp": 4.0, "log": 4.0, "tanh": 6.0, "logistic": 5.0, "erf": 6.0,
    "pow": 8.0, "rsqrt": 2.0, "sqrt": 2.0, "sin": 4.0, "cos": 4.0,
    "integer_pow": 2.0, "div": 2.0, "rem": 2.0,
}
_ZERO_FLOP = frozenset({
    "reshape", "broadcast_in_dim", "transpose", "squeeze", "slice",
    "concatenate", "convert_element_type", "copy", "expand_dims", "iota",
    "select_n", "gather", "split",
})
_UPDATES = frozenset({"scatter", "scatter-add", "dynamic_update_slice"})


def _is_bookkeeping(node: fx.Node) -> bool:
    """Nodes that compute nothing: shape and metadata assertions."""
    return getattr(node.target, "__name__", "").startswith(("_assert",
                                                            "sym_"))


def _op_name(target) -> str:
    """The op's name without namespace or overload (``index_put_``)."""
    packet = getattr(target, "_overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(target, "__name__",
                                                        str(target))
    return name.split(".")[-1]


def _namespace(target) -> str:
    return getattr(target, "namespace", "") or ""


def class_of(target) -> str:
    """The reference's (jaxpr) name for an ATen or ``repro_torch`` op."""
    name = _op_name(target)
    if _namespace(target) == "repro_torch":
        return KERNEL_CLASS.get(name, name)
    return _JAXPR_NAME.get(name, name)


# --------------------------------------------------------------------- #
# Costs
# --------------------------------------------------------------------- #
def _tensors(x) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel()) * t.element_size()


def _val(a):
    """The traced value of an argument (fx nodes -> their meta values)."""
    return pytree.tree_map(
        lambda v: v.meta.get("val") if isinstance(v, fx.Node) else v, a)


def _kernel_flops(name: str, args) -> float:
    """FLOPs of the reference's jnp ops for the same call of a kernel."""
    if name == "flash_decode":            # _sdpa_chunked over the whole T
        q, k = args[0], args[1]
        B, H, D = q.shape
        return 4.0 * B * H * k.shape[1] * D
    if name == "flash_prefill":           # full Sq x Skv logits, causal
                                          # (masked) or not
        q, k = args[0], args[1]
        B, Sq, H, D = q.shape
        return 4.0 * B * H * Sq * k.shape[1] * D
    if name == "gmm":                     # ragged_dot: 2 x lhs x cols
        x, w = args[0], args[1]
        return 2.0 * x.numel() * w.shape[-1]
    if name == "wkv":                     # _wkv_scan: a (B,H,P,P) outer
        r = args[0]                       # product, its bonus, add, the
        B, S, H, P = r.shape              # read-out and the update
        return 7.0 * B * S * H * P * P
    if name == "ssd":                     # _ssd_chunk_scan, per chunk:
        xh, Bm = args[0], args[1]         # C.B^T, W.x, the state terms
        Bb, S, H, P = xh.shape            # and the decay matrices
        N, Q = Bm.shape[-1], args[5] if len(args) > 5 else 128
        nC = -(-S // Q)
        return nC * (2.0 * Bb * Q * Q * N + 2.0 * Bb * Q * Q * H * P
                     + 4.0 * Bb * Q * H * N * P + 7.0 * Bb * Q * Q * H
                     + 2.0 * Bb * H * N * P)
    return 0.0


def _matmul_flops(name: str, args, out: torch.Tensor) -> float:
    """2 x (output elements) x (contracted length)."""
    if name == "einsum":
        eq, ops_ = args[0], args[1]
        lhs, _ = eq.replace(" ", "").split("->")
        sizes: Dict[str, int] = {}
        for spec, t in zip(lhs.split(","), ops_):
            sizes.update(zip(spec, t.shape))
        return 2.0 * math.prod(sizes.values())
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def node_cost(node: fx.Node) -> Tuple[float, float]:
    """(flops, bytes) of one traced node, mirroring ``_eqn_cost``."""
    args = _val(node.args)
    outs = _tensors(node.meta.get("val"))
    in_bytes = sum(_nbytes(t) for t in _tensors(args))
    out_bytes = sum(_nbytes(t) for t in outs)
    name = _op_name(node.target)
    if _namespace(node.target) == "repro_torch":
        return _kernel_flops(name, args), in_bytes + out_bytes
    cls = class_of(node.target)
    if cls == "dot_general":
        return _matmul_flops(name, args, outs[0]), in_bytes + out_bytes
    if cls in _UPDATES:
        # in place: traffic ~ the update, not the whole operand
        if name in ("index_put_", "index_put"):
            upd = _nbytes(args[2])
        elif name in ("copy_",) and isinstance(args[1], torch.Tensor):
            upd = _nbytes(args[1])
        elif name.startswith("scatter") and len(args) > 3 \
                and isinstance(args[3], torch.Tensor):
            upd = _nbytes(args[3])
        else:
            upd = out_bytes
        return 0.0, 2.0 * upd + 64.0
    if cls in _ZERO_FLOP:
        return 0.0, in_bytes + out_bytes
    if cls.startswith("reduce_") or cls in ("argmax", "argmin"):
        return float(sum(t.numel() for t in _tensors(args))), \
            in_bytes + out_bytes
    if cls in ("cumsum", "cumprod", "sort", "top_k"):
        n = float(sum(t.numel() for t in outs))
        mult = math.log2(max(n, 2.0)) if cls in ("sort", "top_k") else 1.0
        return n * mult, in_bytes + out_bytes
    mult = _EW_COST.get(cls, 1.0)
    return float(sum(t.numel() for t in outs)) * mult, in_bytes + out_bytes


# --------------------------------------------------------------------- #
# Storage (buffer) read and write sets
# --------------------------------------------------------------------- #
def _alias_sources(node: fx.Node) -> Tuple[List[Optional[int]], List[int]]:
    """(for each return, the index of the argument it aliases or None;
    the indices of the arguments the op writes) from its schema."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return [], []
    arg_sets = [(i, a.alias_info) for i, a in enumerate(schema.arguments)
                if a.alias_info is not None]
    writes = [i for i, info in arg_sets if info.is_write]
    rets: List[Optional[int]] = []
    for r in schema.returns:
        src = None
        if r.alias_info is not None:
            for i, info in arg_sets:
                if not r.alias_info.before_set \
                        or info.before_set & r.alias_info.before_set:
                    src = i
                    break
        rets.append(src)
    return rets, writes


def _schema_args(node: fx.Node) -> List[Any]:
    """The node's arguments in schema order (kwargs placed by name)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return list(node.args)
    out = list(node.args)
    for a in schema.arguments[len(out):]:
        out.append(node.kwargs.get(a.name, a.default_value
                                   if a.has_default_value() else None))
    return out


# --------------------------------------------------------------------- #
# Analysis result
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TracedGraph:
    """KernelGraph plus everything the executor needs to rebuild stages.

    ``eqns[e]`` is the traced fx node of raw equation ``e`` (the
    counterpart of a jaxpr equation), ``attached[e]`` the ``getitem``
    nodes that unpack its outputs, ``targets[e]`` its ATen target."""

    graph: KernelGraph
    program: Any                               # torch.export.ExportedProgram
    eqns: List[fx.Node]
    eqn_of_node: Dict[int, Tuple[int, ...]]
    attached: Dict[int, Tuple[fx.Node, ...]]
    targets: Dict[int, Any]
    in_spec: Any                               # pytree spec of (args, kw)
    out_spec: Any
    inputs: List[Tuple[str, Any]]              # per placeholder: kind, key
    writes: Dict[int, Tuple[Any, ...]]         # eqn -> storage roots written
    roots: Dict[fx.Node, Tuple[Any, ...]]      # value -> storage roots
    created: Dict[Any, int]                    # root -> eqn that made it
    state_readers: Set[int] = dataclasses.field(default_factory=set)
    state_writers: Set[int] = dataclasses.field(default_factory=set)

    @property
    def fx_graph(self) -> fx.Graph:
        return self.program.graph

    def with_graph(self, graph: KernelGraph) -> "TracedGraph":
        return dataclasses.replace(
            self, graph=graph,
            eqn_of_node={n.idx: n.eqn_ids for n in graph.nodes})


class _Step(torch.nn.Module):
    """``fn`` as a module, so ``torch.export`` can trace it."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def export(fn: Callable, *example_args, **example_kwargs):
    """``torch.export`` of ``fn`` at the example arguments (real, fake or
    meta tensors), keeping the marker regions' tags on the nodes."""
    with fx_traceback.preserve_node_meta():
        return torch.export.export(_Step(fn), tuple(example_args),
                                   example_kwargs, strict=False)


def _storage_key(t: Any, fallback: str) -> Any:
    """Inputs that share a real storage share one root."""
    if isinstance(t, torch.Tensor) and t.device.type != "meta" \
            and not isinstance(t, torch._subclasses.FakeTensor):
        return ("storage", t.untyped_storage().data_ptr(), t.device)
    return ("input", fallback)


# --------------------------------------------------------------------- #
# Main entry point
# --------------------------------------------------------------------- #
def analyze(fn: Callable, *example_args, name: str = "ddg",
            state_argnums: Sequence[int] = (),
            fuse: bool = True, **example_kwargs) -> TracedGraph:
    """Trace ``fn`` and build its kernel graph.

    ``example_args`` may be real tensors or meta tensors (then nothing is
    allocated).  ``state_argnums``: positional args holding
    cross-iteration state (e.g. KV caches, updated in place); the nodes
    that read or write their storage (through views included) are
    reported in ``state_readers`` / ``state_writers`` so the planner can
    pin them (KV pinning)."""
    ep = export(fn, *example_args, **example_kwargs)
    flat, in_spec = pytree.tree_flatten((tuple(example_args),
                                         example_kwargs))
    # which flattened leaves belong to the state arguments
    state_leaves: Set[int] = set()
    offset = 0
    for i, a in enumerate(example_args):
        n = len(pytree.tree_leaves(a))
        if i in state_argnums:
            state_leaves.update(range(offset, offset + n))
        offset += n

    graph = ep.graph
    roots: Dict[fx.Node, Tuple[Any, ...]] = {}
    inputs: List[Tuple[str, Any]] = []
    state_roots: Set[Any] = set()
    user = 0
    specs = {s.arg.name: s for s in ep.graph_signature.input_specs}
    for node in graph.nodes:
        if node.op != "placeholder":
            continue
        spec = specs[node.name]
        kind = spec.kind.name
        if kind == "USER_INPUT":
            leaf = flat[user]
            root = _storage_key(leaf, node.name)
            inputs.append(("user", user))
            if user in state_leaves:
                state_roots.add(root)
            user += 1
        elif kind == "CONSTANT_TENSOR":
            root = ("input", node.name)
            inputs.append(("constant", spec.target))
        elif kind in ("PARAMETER", "BUFFER"):
            root = ("input", node.name)
            inputs.append(("state_dict", spec.target))
        else:
            raise NotImplementedError(f"analyze: input kind {kind}")
        roots[node] = (root,)
    for spec in ep.graph_signature.output_specs:
        if spec.kind.name != "USER_OUTPUT":
            raise NotImplementedError(
                f"analyze: output kind {spec.kind.name} (a functionalized "
                "input mutation); the analyzer expects writes in place")

    nodes: List[KernelNode] = []
    eqns: List[fx.Node] = []
    edges: Dict[Tuple[int, int], float] = {}
    attached: Dict[int, List[fx.Node]] = {}
    producer: Dict[fx.Node, int] = {}          # value -> eqn producing it
    last_writer: Dict[Any, int] = {}
    readers: Dict[Any, Set[int]] = {}
    writes: Dict[int, Tuple[Any, ...]] = {}
    created: Dict[Any, int] = {}
    state_readers: Set[int] = set()
    state_writers: Set[int] = set()

    def edge(i: int, j: int, nbytes: float) -> None:
        if i != j:
            edges[(i, j)] = edges.get((i, j), 0.0) + nbytes

    for node in graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            src, idx = node.args
            roots[node] = (roots[src][idx],)
            if src in producer:
                producer[node] = producer[src]
                attached.setdefault(producer[src], []).append(node)
            continue
        if _is_bookkeeping(node):
            continue
        e = len(eqns)
        eqns.append(node)
        flops, nbytes = node_cost(node)
        phase, block, layer = tags_of(node.meta)
        vals = node.meta.get("val")
        nodes.append(KernelNode(
            idx=e, name=class_of(node.target), flops=flops,
            bytes_accessed=nbytes,
            out_bytes=sum(_nbytes(t) for t in _tensors(vals)),
            phase=phase, block=block, layer=layer, eqn_ids=(e,)))

        sargs = _schema_args(node)
        ret_src, write_args = _alias_sources(node)
        written: Set[Any] = set()
        for i in write_args:
            for v in pytree.tree_leaves(sargs[i]):
                if isinstance(v, fx.Node):
                    written.update(roots[v])
        read: Dict[Any, float] = {}
        for v in pytree.tree_leaves(sargs):
            if not isinstance(v, fx.Node) or v not in roots:
                continue
            b = sum(_nbytes(t) for t in _tensors(v.meta.get("val")))
            if v in producer:                       # the value edge
                edge(producer[v], e, b)
            for r in roots[v]:
                read[r] = max(read.get(r, 0.0), b)
        for r, b in read.items():
            if r in state_roots:
                state_readers.add(e)
            w = last_writer.get(r)
            if w is not None and (w, e) not in edges:
                edge(w, e, b)                       # RAW
            if r not in written:
                readers.setdefault(r, set()).add(e)
        for r in written:
            if r in state_roots:
                state_writers.add(e)
            if r in last_writer:
                edge(last_writer[r], e, 0.0)        # WAW
            for rd in readers.pop(r, ()):
                edge(rd, e, 0.0)                    # WAR
            last_writer[r] = e
        writes[e] = tuple(sorted(written, key=repr))

        # the storage of each output: an aliased argument's, or its own
        roots[node] = _out_roots(node, vals, ret_src, sargs, roots)
        for r in roots[node]:
            if r not in read and r not in written and r[0] == "value":
                created[r] = e                      # a fresh buffer
                last_writer[r] = e
        producer[node] = e

    kg = KernelGraph(nodes, edges, name=name)
    kg.validate()
    traced = TracedGraph(
        graph=kg, program=ep, eqns=eqns,
        eqn_of_node={n.idx: n.eqn_ids for n in nodes},
        attached={e: tuple(v) for e, v in attached.items()},
        targets={e: n.target for e, n in enumerate(eqns)},
        in_spec=in_spec, out_spec=ep.call_spec.out_spec, inputs=inputs,
        writes=writes,
        roots=roots, created=created,
        state_readers=state_readers, state_writers=state_writers)
    if fuse:
        fused = kg.fuse_elementwise()
        old_to_new: Dict[int, int] = {}
        for n in fused.nodes:
            for e in n.eqn_ids:
                old_to_new[e] = n.idx
        traced = dataclasses.replace(
            traced.with_graph(fused),
            state_readers={old_to_new[i] for i in state_readers},
            state_writers={old_to_new[i] for i in state_writers})
    return traced


def _out_roots(node: fx.Node, vals, ret_src: List[Optional[int]],
               sargs: List[Any], roots: Dict[fx.Node, Tuple[Any, ...]]
               ) -> Tuple[Any, ...]:
    """One storage root per output of ``node``: that of the argument the
    schema says it aliases (a view, an in-place result, each piece of a
    ``split``), else a fresh one."""
    n_out = len(vals) if isinstance(vals, (list, tuple)) else 1
    if n_out > 1 and len(ret_src) == 1:          # one list of views
        ret_src = ret_src * n_out
    out = []
    for i in range(n_out):
        src = ret_src[i] if i < len(ret_src) else None
        base = roots_of(sargs[src], roots) if src is not None else ()
        out.append(base[0] if base else ("value", node.name, i))
    return tuple(out)


def roots_of(v: Any, roots: Dict[fx.Node, Tuple[Any, ...]]
             ) -> Tuple[Any, ...]:
    """The storage roots of an argument (a node or a list of nodes)."""
    out: List[Any] = []
    for x in pytree.tree_leaves(v):
        if isinstance(x, fx.Node) and x in roots:
            out.extend(roots[x])
    return tuple(out)


def pin_nodes(graph: KernelGraph, node_ids: Set[int],
              device: int) -> KernelGraph:
    """Return a copy of the graph with the given nodes pinned to a device."""
    nodes = [dataclasses.replace(n, pinned=device) if n.idx in node_ids
             else n for n in graph.nodes]
    return KernelGraph(nodes, dict(graph.edges), name=graph.name)


def matmul_flops(graph: KernelGraph) -> float:
    """FLOPs of the nodes the cost model runs on the matrix units."""
    return sum(n.flops for n in graph.nodes if n.name in _MXU_PRIMS)
