"""The port's kernel analyzer (``repro_torch.core.analyzer``): dependency
extraction from a ``torch.export`` ATen graph (value edges and the
read/write sets of in-place writes), exact matmul FLOPs, marker tags,
fusion, state readers and writers; the five kernels as custom ops
(``opcheck``); and, on each family's smoke decode step, one node per
kernel call and the JAX analyzer's matmul FLOPs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.core import analyzer as JA  # noqa: E402
from repro.core.costmodel import _MXU_PRIMS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import marker  # noqa: E402
from repro_torch.core.analyzer import analyze, matmul_flops  # noqa: E402
from repro_torch.core.graph import KernelGraph, KernelNode  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as S  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as G  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as W  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


def _has_path(g: KernelGraph, i: int, j: int) -> bool:
    succ = {}
    for a, b in g.edges:
        succ.setdefault(a, []).append(b)
    todo, seen = [i], set()
    while todo:
        k = todo.pop()
        if k == j:
            return True
        if k not in seen:
            seen.add(k)
            todo.extend(succ.get(k, ()))
    return False


def _named(tg, name):
    return [n for n in tg.graph.nodes if n.name == name]


# --------------------------------------------------------------------- #
# The reference's analyzer cases
# --------------------------------------------------------------------- #
def test_raw_dependency_extraction():
    def f(x, w):
        a = x @ w
        b = a + 1.0
        return b @ w

    tg = analyze(f, torch.ones(8, 8), torch.ones(8, 8))
    dots = _named(tg, "dot_general")
    assert len(dots) == 2
    assert (dots[0].idx, dots[1].idx) in tg.graph.edges
    assert any(b == 8 * 8 * 4 for b in tg.graph.edges.values())


def test_dot_general_flops_exact():
    tg = analyze(lambda x, w: x @ w, torch.ones(16, 32), torch.ones(32, 64),
                 fuse=False)
    assert _named(tg, "dot_general")[0].flops == 2 * 16 * 32 * 64


def test_batched_dot_flops():
    tg = analyze(lambda x, w: torch.einsum("bij,bjk->bik", x, w),
                 torch.ones(4, 8, 16), torch.ones(4, 16, 32), fuse=False)
    assert _named(tg, "dot_general")[0].flops == 2 * 4 * 8 * 16 * 32
    tg = analyze(torch.bmm, torch.ones(4, 8, 16), torch.ones(4, 16, 32),
                 fuse=False)
    assert _named(tg, "dot_general")[0].flops == 2 * 4 * 8 * 16 * 32


def test_marker_tags_no_marker_nodes():
    def f(x, w1, w2):
        a = marker.wrap(lambda y: y @ w1, block="attention", layer=3)(x)
        return marker.wrap(lambda y: y @ w2, block="ffn", layer=3)(a)

    tg = analyze(f, torch.ones(4, 8), torch.ones(8, 8), torch.ones(8, 8))
    assert {n.block for n in tg.graph.nodes} == {"attention", "ffn"}
    assert all(n.layer == 3 for n in tg.graph.nodes)
    assert len(tg.graph) == 2 and tg.graph.num_edges >= 1


def test_nested_markers_restore_outer_tag():
    def f(x, w):
        x, close = marker.tag(x, phase="decode")
        x = marker.wrap(lambda y: y @ w, block="attention")(x)
        x = x @ w                       # still inside "decode", no block
        x = close(x)
        return x @ w                    # outside every region

    tg = analyze(f, torch.ones(4, 8), torch.ones(8, 8), fuse=False)
    dots = _named(tg, "dot_general")
    assert (dots[0].block, dots[0].phase) == ("attention", "decode")
    assert (dots[1].block, dots[1].phase) == ("", "decode")
    assert (dots[2].block, dots[2].phase, dots[2].layer) == ("", "", -1)


def test_fusion_reduces_elementwise_nodes():
    def f(x, w):
        h = x @ w
        h = torch.tanh(h) * 2.0 + 1.0
        return h @ w

    raw = analyze(f, torch.ones(8, 8), torch.ones(8, 8), fuse=False)
    fused = analyze(f, torch.ones(8, 8), torch.ones(8, 8), fuse=True)
    assert len(fused.graph) < len(raw.graph)
    assert np.isclose(fused.graph.total_flops(), raw.graph.total_flops())


def test_state_reader_writer_detection():
    def step(kv, x):
        read = kv[0] + x.sum()          # reads state
        kv[1] = x.sum()                 # writes state, in place
        return read, kv

    tg = analyze(step, torch.zeros(4), torch.ones(3), state_argnums=(0,),
                 fuse=False)
    assert tg.state_readers and tg.state_writers
    w = next(iter(tg.state_writers))
    assert tg.graph.nodes[w].name in ("dynamic_update_slice", "scatter")


def test_meta_tensor_inputs():
    """Meta tensors trace like real ones (the ShapeDtypeStruct case)."""
    meta = torch.device("meta")
    tg = analyze(lambda x, w: torch.relu(x @ w),
                 torch.empty(128, 256, dtype=torch.bfloat16, device=meta),
                 torch.empty(256, 512, dtype=torch.bfloat16, device=meta))
    assert _named(tg, "dot_general")[0].flops == 2 * 128 * 256 * 512


def test_graph_validate_catches_bad_edge():
    g = KernelGraph([KernelNode(0, "a", 1, 1, 1), KernelNode(1, "b", 1, 1, 1)],
                    {(1, 0): 4.0})
    with pytest.raises(AssertionError):
        g.validate()


def test_layer_signature_groups_fold_identical_layers():
    def f(x, params):
        for i, w in enumerate(params):
            x = marker.wrap(lambda y, a=w: torch.tanh(y @ a), layer=i)(x)
        return x

    tg = analyze(f, torch.ones(4, 8), [torch.ones(8, 8) for _ in range(5)])
    sizes = sorted(len(v) for v in tg.graph.layer_signature_groups().values())
    assert sizes[-1] == 5


# --------------------------------------------------------------------- #
# In-place writes: read/write-set edges
# --------------------------------------------------------------------- #
def test_write_through_view_then_read_is_ordered():
    """A write through one view and a later read through another view of
    the same buffer: the read depends on the write (RAW)."""
    def f(kv, x):
        v = kv[1]
        v[0] = x.sum()                  # write through a view
        return kv[1] * 2.0              # read through another view

    tg = analyze(f, torch.zeros(3, 4), torch.ones(4), fuse=False)
    (w,) = [n.idx for n in tg.graph.nodes
            if n.name in ("dynamic_update_slice", "scatter")]
    (mul,) = _named(tg, "mul")
    assert _has_path(tg.graph, w, mul.idx)


def test_read_then_write_in_place_is_ordered():
    """A read of a buffer and a later in-place write of it: the write
    depends on the read (WAR), though no value flows between them."""
    def f(kv, x):
        a = kv * 2.0
        kv.add_(x)
        return a

    tg = analyze(f, torch.zeros(4), torch.ones(4), state_argnums=(0,),
                 fuse=False)
    (mul,) = _named(tg, "mul")
    (add,) = _named(tg, "add")
    assert (mul.idx, add.idx) in tg.graph.edges
    assert add.idx in tg.state_writers and mul.idx in tg.state_readers


def test_fusion_never_moves_a_read_past_a_write():
    """An elementwise read of a buffer that is written before its
    consumer runs is not fused into that consumer."""
    def f(kv, w):
        a = kv + 1.0                    # elementwise read
        kv.mul_(3.0)                    # then an in-place write
        return a @ w

    raw = analyze(f, torch.ones(4, 4), torch.ones(4, 4), fuse=False)
    fused = analyze(f, torch.ones(4, 4), torch.ones(4, 4))
    add = _named(raw, "add")[0].idx
    dot = _named(fused, "dot_general")[0]
    assert add not in dot.eqn_ids


def test_mutating_op_declares_its_write():
    """K4's op writes its state in place: its node is a state writer."""
    def f(r, k, v, w, u, s):
        return W.wkv(r, k, v, w, u, s)

    g = torch.Generator().manual_seed(0)
    r = torch.randn(1, 2, 2, 8, generator=g)
    tg = analyze(f, r, r, r, torch.rand(1, 2, 2, 8, generator=g),
                 torch.randn(2, 8, generator=g), torch.zeros(1, 2, 8, 8),
                 state_argnums=(5,), fuse=False)
    (scan,) = _named(tg, "scan")
    assert scan.idx in tg.state_writers and scan.idx in tg.state_readers


# --------------------------------------------------------------------- #
# The kernels as custom ops
# --------------------------------------------------------------------- #
def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    return {
        "flash_decode": (FA.FLASH_DECODE, (
            r(2, 8, 64), r(2, 20, 2, 64), r(2, 20, 2, 64),
            torch.tensor([5, 20], dtype=torch.int32))),
        "flash_prefill": (FA.FLASH_PREFILL, (
            r(2, 6, 8, 64), r(2, 6, 2, 64), r(2, 6, 2, 64), 0, 3)),
        "gmm": (G.GMM, (r(6, 16), r(3, 16, 8),
                        torch.tensor([2, 0, 4], dtype=torch.int32))),
        "wkv": (W.WKV, (r(2, 3, 2, 8), r(2, 3, 2, 8), r(2, 3, 2, 8),
                        torch.rand(2, 3, 2, 8, generator=g), r(2, 8),
                        r(2, 2, 8, 8))),
        "ssd": (S.SSD, (r(2, 5, 3, 4), r(2, 5, 6), r(2, 5, 6),
                        -torch.rand(2, 5, 3, generator=g), r(2, 3, 6, 4),
                        4)),
    }


@pytest.mark.parametrize("name", ["flash_decode", "flash_prefill", "gmm",
                                  "wkv", "ssd"])
def test_opcheck_custom_ops(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    assert str(op).startswith(f"repro_torch.{name}")


def test_ops_have_no_python_device_test():
    """The dispatcher, not Python, picks the kernel: on a meta tensor the
    op runs its fake implementation and launches nothing."""
    from repro_torch.kernels.flash_attention import kernel as FK
    before = dict(FK.LAUNCHES)
    op, args = _op_cases()["flash_decode"]
    out = op(*[a.to("meta") for a in args])
    assert out.device.type == "meta" and out.shape == args[0].shape
    assert FK.LAUNCHES == before


# --------------------------------------------------------------------- #
# The families' decode steps
# --------------------------------------------------------------------- #
B, T = 2, 16
# kernel nodes per smoke decode step (2 layers; the hybrid's shared
# attention block is applied twice; encdec: a self- and a cross-attention
# K1 per layer)
KERNEL_NODES = {
    "llama3_8b": {"flash_attention": 2},
    "gpt_oss_20b": {"flash_attention": 2, "ragged_dot": 6},
    "rwkv6_3b": {"scan": 2},
    "zamba2_7b": {"flash_attention": 2},
    "seamless_m4t_large_v2": {"flash_attention": 4},
    "qwen2_vl_7b": {"flash_attention": 2},
}
# qwen2-vl's step takes this token's M-RoPE ids (3, B, 1) too: text ids
# that differ from the positions, as after an image
POSITIONS3 = [[[0], [2]]] * 3


def _port_step(arch):
    cfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, generator=g, device="cpu")
    cache = TM.init_cache(cfg, B, T, device="cpu")
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([2, 4], dtype=torch.int32)
    if cfg.family == "vlm":
        return analyze(lambda p, c, t, q, p3: TM.decode_step(
            p, cfg, t, c, q, positions3=p3, tagged=True),
            params, cache, toks, pos,
            torch.tensor(POSITIONS3, dtype=torch.int32), state_argnums=(1,),
            fuse=False)
    return analyze(lambda p, c, t, q: TM.decode_step(p, cfg, t, c, q,
                                                     tagged=True),
                   params, cache, toks, pos, state_argnums=(1,), fuse=False)


def _jax_step(arch):
    cfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    cache = JM.init_cache(cfg, B, T)
    args = (params, cache, jnp.array([[3], [5]], jnp.int32),
            jnp.array([2, 4], jnp.int32))
    if cfg.family == "vlm":
        return JA.analyze(lambda p, c, t, q, p3: JM.decode_step(
            p, cfg, t, c, q, positions3=p3, scan_layers=False), *args,
            jnp.array(POSITIONS3, jnp.int32), state_argnums=(1,),
            fuse=False)
    return JA.analyze(lambda p, c, t, q: JM.decode_step(
        p, cfg, t, c, q, scan_layers=False), *args,
        state_argnums=(1,), fuse=False)


@pytest.mark.parametrize("arch", list(KERNEL_NODES))
def test_decode_step_one_node_per_kernel_call(arch):
    tg = _port_step(arch)
    kernels = {k: len(_named(tg, k))
               for k in ("flash_attention", "ragged_dot", "scan")}
    assert {k: v for k, v in kernels.items() if v} == KERNEL_NODES[arch]
    # every node touching the cache is reported, and the cache's in-place
    # writes are state writers
    assert tg.state_writers and tg.state_readers >= tg.state_writers
    tags = {(n.block, n.layer) for n in tg.graph.nodes if n.block}
    if arch == "seamless_m4t_large_v2":
        # the reference's encdec bodies carry no markers, nor do the
        # port's; the cross caches' readers are state readers (K1 reads
        # them whole)
        assert not tags
        kernels = [n.idx for n in _named(tg, "flash_attention")]
        assert set(kernels) <= tg.state_readers
        return
    assert {b for b, _ in tags} <= {"attention", "ffn", "moe", "ssm"}
    assert {layer for _, layer in tags} >= {0, 1}


@pytest.mark.parametrize("arch", ["llama3_8b", "gpt_oss_20b", "rwkv6_3b",
                                  "zamba2_7b", "seamless_m4t_large_v2",
                                  "qwen2_vl_7b"])
def test_decode_step_matmul_flops_equal_jax(arch):
    """Total matmul FLOPs (the cost model's matrix-unit classes) equal the
    JAX analyzer's on the same config.  The MoE step's expert matmuls:
    JAX 0.9 binds ``ragged_dot_general``, which the reference analyzer
    costs as elementwise, so they are compared with its formula for
    ``ragged_dot`` (2 x lhs x cols) apart from the dense matmuls."""
    tg, jg = _port_step(arch), _jax_step(arch)
    jax_mxu = sum(n.flops for n in jg.graph.nodes if n.name in _MXU_PRIMS)
    if arch != "gpt_oss_20b":
        assert matmul_flops(tg.graph) == jax_mxu
        return
    ragged = _named(tg, "ragged_dot")
    assert matmul_flops(tg.graph) - sum(n.flops for n in ragged) == jax_mxu
    cfg = TC.get_smoke(arch)
    rows = B * cfg.experts_per_token
    want = rows * 2.0 * cfg.d_model * cfg.d_ff * 3 * cfg.num_layers
    assert sum(n.flops for n in ragged) == want
    jr = [n for n in jg.graph.nodes if n.name == "ragged_dot_general"]
    assert len(jr) == len(ragged)
