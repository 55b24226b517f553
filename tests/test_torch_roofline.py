"""The port's roofline (``repro_torch.roofline.{hlo,report}``) against the
reference's, and K1-K5's FLOP formulas (``kernels/cost.py``).

  * each collective's per-chip traffic equals the reference's
    ``collective_bytes`` of an HLO line of the same dtype, shape and
    group, for all five ops;
  * ``model_flops`` equals the reference's for every (arch x shape);
  * ``analyze_record``, ``fix_note`` and ``fmt_table`` give the
    reference's rows and text under the reference's constants;
  * each kernel op's FLOP formula is what ``FlopCounterMode`` counts on
    the op, equals its count of the plain version at non-causal shapes
    (K1 over the whole cache, K2 not causal, K3), and the closed form at
    causal and windowed ones (K2), and at K4 / K5, whose plain versions'
    matmuls are a known part of the recurrences' arithmetic;
  * the four ported modules import without JAX and without ``repro``.

In process: only ``repro.roofline.{hlo,report}`` of the reference, which
set nothing at import.
"""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.roofline import hlo as RH  # noqa: E402
from repro.roofline import report as RR  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.roofline import hlo as H  # noqa: E402
from repro_torch.roofline import report as R  # noqa: E402

SIZES = {"bf16": 2, "f32": 4, "s32": 4, "s8": 1}


def _line(op: str, dtype: str, shape, n: int) -> str:
    dims = ",".join(str(d) for d in shape)
    groups = f", replica_groups=[{256 // n},{n}]<=[256]" if n > 1 else ""
    return (f"  %x.1 = {dtype}[{dims}]{{1,0}} {op}({dtype}[{dims}]{{1,0}} "
            f"%p.0){groups}, dimensions={{0}}")


@pytest.mark.parametrize("op", H.COLLECTIVES)
@pytest.mark.parametrize("dtype,shape,n", [("bf16", (16, 4096), 16),
                                           ("f32", (8, 128, 64), 2),
                                           ("s8", (1024,), 256),
                                           ("bf16", (32, 7), 1)])
def test_collective_traffic_matches_reference(op, dtype, shape, n):
    nbytes = float(np.prod(shape) * SIZES[dtype])
    want = RH.collective_bytes(_line(op, dtype, shape, n))
    got = H.collective_bytes([H.Collective(op, nbytes, n)])
    assert got == want
    # and two of them, with an empty one skipped as the reference skips it
    want2 = RH.collective_bytes("\n".join([_line(op, dtype, shape, n)] * 2))
    got2 = H.collective_bytes([H.Collective(op, nbytes, n),
                               H.Collective(op, nbytes, n),
                               H.Collective(op, 0.0, n)])
    assert got2 == want2


def test_model_flops_match_reference():
    from repro_torch.models.config import SHAPES
    import repro_torch.configs as C
    for arch, shape in itertools.product(C.ARCHS, SHAPES):
        assert R.model_flops(arch, shape) == RR.model_flops(arch, shape), \
            (arch, shape)


REF_TERMS = {"peak_flops": RR.PEAK_FLOPS, "hbm_bw": RR.HBM_BW,
             "link_bw": RR.LINK_BW}
# the reference's notes, for its v5e terms
REF_NOTES = {
    "collective": ("reshard/collective-bound: cut all-gather volume "
                   "(better weight layout, overlap, or compression)"),
    "memory_decode": ("HBM-bound (weight+KV streaming): quantize KV/"
                      "weights or raise batch to amortize reads"),
    "memory": "HBM-bound: improve fusion / remat policy to cut traffic",
    "compute": ("compute-bound: good — push MXU utilization via tiling "
                "(Pallas kernels) and reduce non-GEMM flops"),
}


def _records():
    rng = np.random.default_rng(0)
    recs = []
    for i, (arch, shape) in enumerate(itertools.product(
            ["llama3_8b", "gpt_oss_20b", "rwkv6_3b"],
            ["train_4k", "prefill_32k", "decode_32k", "long_500k"])):
        # compute-, memory- and collective-bound in turn
        f, b, c = (float(x) * s for x, s in zip(
            rng.uniform(1, 2, 3), np.roll([1e15, 1e10, 1e6], i % 3)))
        rec = {"arch": arch, "shape": shape, "ok": True, "devices": 256,
               "compile_s": 1.5,
               "memory": {"argument_bytes": 1e9, "temp_bytes": 2e9,
                          "output_bytes": 0, "alias_bytes": 0},
               "cost": {"flops": f, "bytes": b},
               "collectives": {"per_chip_bytes": c}}
        if i % 2:
            rec["extrapolated"] = {"flops": 2 * f, "bytes": b / 3,
                                   "collective_per_chip_bytes": c}
        recs.append(rec)
    recs.append({"arch": "llama3_8b", "shape": "long_500k", "ok": False,
                 "skipped": True})
    return recs


def test_analysis_and_table_match_reference():
    rows, want_rows = [], []
    for rec in _records():
        got, want = R.analyze_record(rec, **REF_TERMS), RR.analyze_record(rec)
        assert got == want
        if want:
            rows.append(got)
            want_rows.append(want)
            assert R.fix_note(got, REF_NOTES) == RR.fix_note(want)
    assert {r["dominant"] for r in rows} == {"compute", "memory",
                                             "collective"}
    assert R.fmt_table(rows, REF_NOTES) == RR.fmt_table(want_rows)


def test_report_defaults_are_the_h100s():
    from repro_torch.core.costmodel import GPU_H100
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert R.PEAK_FLOPS == GPU_H100.peak_flops
    assert "989 TFLOP/s" in R.terms_line()


# --------------------------------------------------------------------- #
# K1-K5's FLOP formulas
# --------------------------------------------------------------------- #
def _flops(fn, *a, **kw) -> float:
    with FlopCounterMode(display=False) as fc:
        fn(*a, **kw)
    return float(fc.get_total_flops())


def _pairs_brute(Sq, Skv, q_offset, window, causal) -> int:
    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    m = (kp <= qp) if causal else np.ones((Sq, Skv), bool)
    if window is not None:
        m &= kp > qp - window
    return int(m.sum())


def test_k1_formula_is_the_plain_count_over_the_cache():
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator().manual_seed(0)
    B, H, Hkv, T, D = 3, 8, 2, 37, 16
    q = torch.randn(B, H, D, generator=g)
    k, v = (torch.randn(B, T, Hkv, D, generator=g) for _ in range(2))
    lengths = torch.tensor([37, 5, 20], dtype=torch.int32)
    want = cost.decode(B, H, Hkv, D, B * T, 4)[0]
    assert _flops(ops.decode_attention, q, k, v, lengths) == want
    assert _flops(ref.decode_attention, q, k, v, lengths) == want


@pytest.mark.parametrize("Sq,Skv,q_offset,window,causal", [
    (16, 16, 0, None, False), (7, 30, 0, None, False),
    (16, 16, 0, None, True), (8, 24, 16, None, True), (32, 32, 0, 5, True),
    (9, 40, 31, 12, True), (12, 12, 0, 4, False)])
def test_k2_formula(Sq, Skv, q_offset, window, causal):
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator().manual_seed(1)
    B, H, Hkv, D = 2, 4, 2, 8
    q = torch.randn(B, Sq, H, D, generator=g)
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g) for _ in range(2))
    pairs = cost.prefill_pairs(Sq, Skv, q_offset, window, causal)
    assert pairs == _pairs_brute(Sq, Skv, q_offset, window, causal)
    want = cost.prefill(B, Sq, Skv, H, Hkv, D, pairs, 4)[0]
    kw = dict(q_offset=q_offset, window=window, causal=causal)
    assert _flops(ops.prefill_attention, q, k, v, **kw) == want
    if not causal and window is None:      # the plain version's products
        assert _flops(ref.prefill_attention, q, k, v, **kw) == want


def test_k3_formula_is_the_plain_count():
    from repro_torch.kernels.moe_gmm import ops, ref
    g = torch.Generator().manual_seed(2)
    sizes = [3, 0, 5, 1]
    x = torch.randn(sum(sizes), 16, generator=g)
    w = torch.randn(4, 16, 24, generator=g)
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = cost.gmm(sum(sizes), 16, 24, 3, 4)[0]
    assert _flops(ops.gmm, x, w, gs) == want == _flops(ref.gmm, x, w, gs)


def test_k4_k5_formulas_are_the_recurrences():
    from repro_torch.kernels.mamba2_ssd import ops as SO, ref as SR
    from repro_torch.kernels.rwkv6 import ops as WO, ref as WR
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 10, 3, 8, 4
    r, k, v = (torch.randn(B, S, H, P, generator=g) for _ in range(3))
    w = torch.rand(B, S, H, P, generator=g)
    u = torch.randn(H, P, generator=g)
    # the read-out and the state update, 2 P each per channel and token;
    # the plain version's counted products are the read-out's
    want = 4.0 * B * S * H * P * P
    assert cost.wkv(B, S, H, P, 4)[0] == want
    assert _flops(WO.wkv, r, k, v, w, u, torch.zeros(B, H, P, P)) == want
    assert 2 * _flops(WR.wkv, r, k, v, w, u, torch.zeros(B, H, P, P)) \
        == want
    xh = torch.randn(B, S, H, P, generator=g)
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    a_log = -torch.rand(B, S, H, generator=g)
    want = 4.0 * B * S * H * N * P
    assert cost.ssd(B, S, H, P, N, 4)[0] == want
    assert _flops(SO.ssd, xh, Bm, Cm, a_log, torch.zeros(B, H, N, P),
                  chunk=4) == want
    # the plain version's chunked form does more (its intra-chunk
    # products): the formula is the recurrence's, below it
    assert _flops(SR.ssd, xh, Bm, Cm, a_log, torch.zeros(B, H, N, P),
                  chunk=4) > want


def test_ported_modules_import_without_jax():
    probe = ("import sys\n"
             "import repro_torch.launch.dryrun, repro_torch.launch.inspect_cell\n"
             "import repro_torch.roofline.hlo, repro_torch.roofline.report\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'repro'))\n"
             "import os\n"
             "print(bad, os.environ.get('XLA_FLAGS'))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), os.pardir,
                                     "src")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] None"
