"""Local regions of DTensor code: what the model needs to run with every
parameter, cache and batch leaf a ``DTensor``.

Most of the model runs on DTensors as it stands: DTensor's sharding
propagation picks each op's placements and inserts the collectives.
Some calls need a region where each rank works on its own shards,
with placements chosen here (``local_call``):

* the kernels' custom ops that replace a state in place (K4, K5):
  DTensor would redistribute the state to a strategy's placement, a
  copy, and the write would be lost;
* attention (K1, K2, and the training form): query heads sharded over
  ``model`` where the KV heads are not (GQA with fewer KV heads than
  ranks) need each rank to slice the KV heads its query heads read; a
  decode cache sharded over its sequence axis T stays sharded: each
  rank attends over its own slots (K1's log-sum-exp form) and the
  partial softmaxes are merged by three small all-reduces, as the
  reference's compiled step does;
* in-place writes into a sharded cache (``index_put_``, slice
  assignment), which DTensor refuses when they would move the cache:
  each rank writes the positions that its shard holds;
* the products that split a head axis (``contract``), which DTensor
  cannot do where the mesh does not divide the heads, and the
  vocab-sharded embedding, whose masked partial DTensor cannot take
  back in the gradient.  Row-parallel outputs are summed at once
  (``reduced``): a partial residual makes DTensor shard the sequence.

``sharded(tree)`` is the context of a model entry point: plain tensors
made inside it (``arange``, ``zeros``) count as replicated, and the
mesh of the tree's DTensors becomes the ambient mesh when none is set.
Nothing here runs for plain tensors.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from repro_torch.distributed.context import current_mesh, mesh_context

Placements = Tuple[Placement, ...]


def is_dtensor(*xs: Any) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def mesh_of(*xs: Any):
    """The mesh of the first DTensor among ``xs``."""
    return next(x for x in xs if isinstance(x, DTensor)).device_mesh


def placements_of(t: Any, mesh) -> Placements:
    """``t``'s placements; a plain tensor is replicated."""
    return tuple(t.placements) if isinstance(t, DTensor) \
        else (Replicate(),) * mesh.ndim


def first_dtensor(tree: Any) -> Optional[DTensor]:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, DTensor):
            return leaf
    return None


@contextlib.contextmanager
def sharded(tree: Any) -> Iterator[None]:
    """When ``tree`` holds a DTensor: plain tensors mix with DTensors as
    replicated ones (DTensor's implicit replication, restored on exit
    as it was), and the DTensors' mesh is the ambient mesh unless one is
    set.  Otherwise nothing."""
    dt = first_dtensor(tree)
    if dt is None:
        yield
        return
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    ctx = mesh_context(dt.device_mesh) if current_mesh() is None \
        else contextlib.nullcontext()
    try:
        with ctx:
            yield
    finally:
        disp._allow_implicit_replication = prev


def reduced(t: Any) -> Any:
    """``t`` with every partial placement summed (replicated); a plain
    tensor as it is."""
    if not isinstance(t, DTensor) or \
            not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def local_box(shape: Sequence[int], mesh, placements: Sequence[Placement]
              ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of ``shape`` at ``placements``: its
    sizes and its offsets, in Python ints (DTensor's own helper makes
    tensors, which a fake-tensor trace cannot read).  A dimension
    sharded on several mesh dimensions is cut major to minor, each cut
    into ``ceil`` chunks, as DTensor cuts it."""
    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim
            chunk = -(-size[d] // mesh.shape[i])
            start = min(coord[i] * chunk, size[d])
            off[d] += start
            size[d] = max(0, min(chunk, size[d] - start))
    return tuple(size), tuple(off)


def splittable(t: DTensor, dim: int, lead: int) -> DTensor:
    """``t`` placed so that dimension ``dim`` can split into (``lead``,
    rest): the shards of ``dim`` that ``lead`` does not divide are
    gathered."""
    pl = list(t.placements)
    n = 1
    for i in shard_dims(pl, dim):
        n *= t.device_mesh.shape[i]
        if lead % n:
            pl[i] = Replicate()
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def embedding(tokens: Any, table: Any) -> DTensor:
    """Rows of ``table`` (V, d) at ``tokens``, each rank from its shard:
    on a mesh dimension sharding the vocabulary, a rank looks up the
    tokens its rows hold (zeros elsewhere), a partial sum; on one
    sharding the batch, its own tokens.  The sums are added at once.
    (DTensor's own embedding strategy is a masked partial whose
    gradient its redistribution cannot take.)"""
    mesh = mesh_of(tokens, table)
    R = Replicate()
    tt, wt, out, wg = [], [], [], []
    for pt, pw in zip(placements_of(tokens, mesh),
                      placements_of(table, mesh)):
        if isinstance(pw, Shard) and pw.dim == 0:
            tt.append(R), wt.append(pw), out.append(Partial())
            wg.append(pw)
        elif isinstance(pt, Shard) and pt.dim == 0:
            tt.append(pt), wt.append(R), out.append(Shard(0))
            wg.append(Partial())
        else:
            tt.append(R), wt.append(R), out.append(R), wg.append(R)
    v0 = local_box(table.shape, mesh, tuple(wt))[1][0]

    def fn(tok, w):
        t = tok.long() - v0
        hit = (t >= 0) & (t < w.shape[0])
        rows = w.index_select(0, t.clamp(0, w.shape[0] - 1).reshape(-1))
        rows = rows.view(*tok.shape, -1)
        return torch.where(hit[..., None], rows, torch.zeros_like(rows))
    shape = tuple(tokens.shape) + (table.shape[1],)
    return reduced(local_call(fn, mesh, [(tokens, tuple(tt)),
                                         (table, tuple(wt), tuple(wg))],
                              [(tuple(out), shape)]))


def matmul(x: Any, w: Any) -> Any:
    """``x @ w`` for x (B, S, d) and w (d, f); on DTensors a ``contract``
    (batch or column sharded, or a partial sum over a sharded d), so
    that no sequence sharding reaches it."""
    if is_dtensor(x, w):
        return contract(x, w, 1, torch.matmul)
    return x @ w


def offsets(t: DTensor, placements: Optional[Sequence[Placement]] = None
            ) -> Tuple[int, ...]:
    """This rank's offset into each dimension of ``t`` placed at
    ``placements`` (default: its own)."""
    return local_box(t.shape, t.device_mesh, placements or t.placements)[1]


def to_local(t: Any, mesh, placements: Sequence[Placement],
             grad_placements: Optional[Sequence[Placement]] = None) -> Any:
    """``t``'s local shard at ``placements``: a DTensor is redistributed
    (a collective where a shard must grow), a plain tensor is taken as
    replicated and sliced; anything else passes through.
    ``grad_placements``: how the local gradient is placed (default: as
    ``placements``)."""
    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local(grad_placements=grad_placements)
    if isinstance(t, torch.Tensor):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
                                      mesh, placements).to_local()
    return t


def wrap(local: torch.Tensor, mesh, placements: Sequence[Placement],
         shape: Sequence[int]) -> DTensor:
    """A DTensor of global ``shape`` (contiguous) from this rank's
    ``local`` shard."""
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def local_call(fn: Callable, mesh, args: Sequence[Tuple],
               out: Sequence[Tuple[Placements, Sequence[int]]]) -> Any:
    """``fn`` on each argument's local shard: ``args`` holds (argument,
    placements) or (argument, placements, gradient placements); each
    output wrapped as a DTensor of (placements, global shape)."""
    res = fn(*(to_local(a[0], mesh, *a[1:]) for a in args))
    if len(out) == 1:
        return wrap(res, mesh, *out[0])
    return tuple(wrap(r, mesh, *o) for r, o in zip(res, out))


def shard_dims(placements: Sequence[Placement], dim: int) -> List[int]:
    """The mesh dimensions on which ``dim`` is sharded."""
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]


def mapped(placements: Sequence[Placement], dims: dict) -> Placements:
    """``placements`` with each ``Shard(d)`` renamed ``Shard(dims[d])``
    (``dims[d]`` None: replicated) and every other placement
    replicated."""
    out = []
    for p in placements:
        d = dims.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(d) if d is not None else Replicate())
    return tuple(out)


# --------------------------------------------------------------------- #
# Head projections on DTensors
# --------------------------------------------------------------------- #
def contract(x: Any, w: Any, nc: int, fn: Callable) -> DTensor:
    """``fn(x, w)``: x (B, S, c_1..c_nc) contracted with w (c_1..c_nc,
    o_1..), giving (B, S, o_1..), each rank on its shards.  The
    attention projections flatten and split their head axes, which
    DTensor cannot do where the heads do not split evenly over the mesh
    (and its backward picks such placements on its own), so their
    placements are chosen here, on each mesh dimension:

    * x batch-sharded: the weight gathered, the output batch-sharded;
    * else the weight sharded on an output axis: x whole, the output
      sharded on that axis;
    * else the weight sharded on a contraction axis: x sharded on it,
      the output a partial sum;
    * else everything whole.

    Each gradient placement says what a rank's local gradient is (a
    partial sum where the other operand was sharded on a dimension and
    this one was not)."""
    mesh = mesh_of(x, w)
    R = Replicate()
    xc = len(x.shape) - nc                      # x's first contraction dim
    xt, wt, out, xg, wg = [], [], [], [], []
    for px, pw in zip(placements_of(x, mesh), placements_of(w, mesh)):
        if isinstance(px, Shard) and px.dim == 0:
            xt.append(Shard(0)), wt.append(R), out.append(Shard(0))
            xg.append(Shard(0)), wg.append(Partial())
        elif isinstance(pw, Shard) and pw.dim >= nc:
            xt.append(R), wt.append(pw), out.append(Shard(xc + pw.dim - nc))
            xg.append(Partial()), wg.append(pw)
        elif isinstance(pw, Shard):
            xt.append(Shard(xc + pw.dim)), wt.append(pw)
            out.append(Partial())
            xg.append(Shard(xc + pw.dim)), wg.append(pw)
        else:
            xt.append(R), wt.append(R), out.append(R)
            xg.append(R), wg.append(R)
    shape = tuple(x.shape[:xc]) + tuple(w.shape[nc:])
    return local_call(fn, mesh, [(x, tuple(xt), tuple(xg)),
                                 (w, tuple(wt), tuple(wg))],
                      [(tuple(out), shape)])


# --------------------------------------------------------------------- #
# Attention (K1, K2) on DTensors
# --------------------------------------------------------------------- #
def merge_partials(o: torch.Tensor, lse: torch.Tensor,
                   amax: Callable = lambda t: t.amax(0),
                   asum: Callable = lambda t: t.sum(0)) -> torch.Tensor:
    """The softmax attention over the union of disjoint key sets, from
    each set's output ``o`` (..., D), float32, and log-sum-exp ``lse``
    (...): ``sum w o / sum w`` with ``w = exp(lse - max lse)``.  By
    default the sets are stacked on dimension 0; ``attend`` passes
    all-reduces over the mesh dimensions that shard T instead.  A set
    with no key (lse -1e30) weighs nothing; a row with none in any set
    gives 0.  -> float32, without the stacked dimension."""
    w = torch.exp(lse - amax(lse))
    return asum(w[..., None] * o) / asum(w)[..., None]


def _reduce_over(mesh, dims: Sequence[int], op: str) -> Callable:
    """An all-reduce (``op``: "max", "sum") of a local tensor over the
    mesh dimensions ``dims``, one after another."""
    from torch.distributed import _functional_collectives as funcol

    def fn(t: torch.Tensor) -> torch.Tensor:
        for i in dims:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t
    return fn


def attend(kernel: Callable, q: Any, k: Any, v: Any, *rest: Any,
           partial: Optional[Callable] = None) -> Any:
    """``kernel(q, k, v, *rest)`` for GQA attention with q (B, [S,] H, D)
    and k/v (B, T, Hkv, D), any of them a DTensor; ``rest`` is K1's
    lengths (B,) or K2's Python arguments.

    Each mesh dimension keeps q's batch or head sharding; any other
    placement of q (and every placement of k/v that differs) is
    gathered, with one exception: given K1's log-sum-exp form
    ``partial(q, k, v, lengths) -> (o float32, lse)``, a mesh dimension
    that shards the cache over T keeps it so.  Each
    rank there attends with every query head over its own slots, its
    lengths clipped to them (``clamp(lengths - t0, 0, T_local)``; a ring
    buffer's valid slots are a prefix as well), and the shards are
    merged by ``merge_partials`` over all-reduces (max of the
    log-sum-exp, sums of the weighted outputs and of the weights): q is
    gathered over that dimension, the output replicated on it, in q's
    dtype.  Where the query heads are sharded and the KV heads cannot
    follow (GQA with fewer KV heads than shards), k/v stay whole on
    those dimensions and each rank slices the KV heads its query heads
    read.  The output is placed as q (replicated where T was split)."""
    mesh = mesh_of(q, k, v)
    qh = len(q.shape) - 2                      # q's head dimension
    H, Hkv = q.shape[qh], k.shape[2]
    rep = H // Hkv
    qpl = placements_of(q, mesh)
    lengths = rest[:1] if rest and isinstance(rest[0], torch.Tensor) else ()
    t_dims = [] if partial is None else [
        i for i in shard_dims(placements_of(k, mesh), 1)
        if i in shard_dims(placements_of(v, mesh), 1)]
    qpl = tuple(Replicate() if i in t_dims else p for i, p in enumerate(qpl))
    heads = shard_dims(qpl, qh)
    n_h = math.prod(mesh.shape[i] for i in heads)
    Hl = H // n_h
    kv_sharded = Hkv % n_h == 0
    if heads and (H % n_h or not (kv_sharded or Hl % rep == 0
                                  or rep % Hl == 0)):
        heads, n_h, Hl, kv_sharded = [], 1, H, True
    q_to = mapped(qpl, {0: 0, **({qh: qh} if heads else {})})
    kv_to = tuple(Shard(1) if i in t_dims else p for i, p in
                  enumerate(mapped(q_to, {0: 0, qh: 2 if kv_sharded
                                          else None})))
    row_to = mapped(q_to, {0: 0})
    # k/v whole but sliced on a head-sharded dimension: each rank's
    # gradient is its heads' share of the sum
    kv_grad = tuple(Partial() if i in heads and not kv_sharded else p
                    for i, p in enumerate(kv_to))
    args = [(q, q_to), (k, kv_to, kv_grad), (v, kv_to, kv_grad)] + \
        [(x, row_to) for x in lengths]
    h0 = 0
    if not kv_sharded:
        h0 = offsets(q if isinstance(q, DTensor)
                     else wrap(q, mesh, qpl, q.shape), q_to)[qh]

    t0 = local_box(k.shape, mesh, kv_to)[1][1]

    def fn(ql, kl, vl, *ln):
        if not kv_sharded:                     # the KV heads of h0 .. h0+Hl
            lo = h0 // rep
            hi = lo + max(Hl // rep, 1)
            kl, vl = kl[:, :, lo:hi].contiguous(), vl[:, :, lo:hi].contiguous()
        if not t_dims:
            return kernel(ql, kl, vl, *ln, *rest[len(lengths):])
        # this rank's slots t0 .. t0 + T_local of each row's valid prefix
        n = (ln[0] - t0).clamp(0, kl.shape[1]).to(torch.int32)
        o, lse = partial(ql, kl, vl, n)
        return merge_partials(o, lse, _reduce_over(mesh, t_dims, "max"),
                              _reduce_over(mesh, t_dims, "sum")
                              ).to(ql.dtype)
    return local_call(fn, mesh, args, [(q_to, q.shape)])


# --------------------------------------------------------------------- #
# In-place writes into a sharded cache (B, T, Hkv, D)
# --------------------------------------------------------------------- #
def write_cache(cache: DTensor, val: Any, index: Sequence[Any],
                write: Callable) -> None:
    """``write(local cache, local val, local index tensors, t0)`` on this
    rank's shard of ``cache``, t0 its first slot: val (B, S, Hkv, D)
    takes the cache's placements with T replicated, each index tensor
    (B,) the cache's batch placements."""
    mesh, cpl = cache.device_mesh, cache.placements
    val_pl = mapped(cpl, {0: 0, 2: 2, 3: 3})
    idx_pl = mapped(cpl, {0: 0})
    t0 = offsets(cache)[1]
    write(cache.to_local(), to_local(val, mesh, val_pl),
          [to_local(i, mesh, idx_pl) for i in index], t0)
