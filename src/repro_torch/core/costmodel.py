"""Device catalog + roofline cost model.

The paper profiles each kernel on each GPU offline (§III-A).  We have no
heterogeneous hardware in this container, so kernel latency is derived from
the same roofline logic the paper uses to *explain* its measurements
(§II-C): ``t = max(flops / peak_flops_eff, bytes / hbm_bw_eff) + launch``.

Two catalogs are provided:
  * TPU types (the deployment target of this framework), and
  * the paper's own GPU table (Table I) so the paper's figures (kernel
    heterogeneity CDFs, cost-efficiency table) can be reproduced with the
    authors' hardware constants.

A measured-calibration hook lets real profiles override the analytic model
(`DeviceSpec.calibrate`), which is how this maps back onto the paper's
profile-then-plan flow on real clusters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

from repro_torch.core.graph import KernelGraph, KernelNode


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator type. Units: FLOP/s, byte/s, bytes, $/hr."""

    name: str
    peak_flops: float              # dense bf16/fp16 tensor throughput
    vector_flops: float            # scalar/vector unit throughput (fp32)
    hbm_bw: float                  # HBM bandwidth
    hbm_bytes: float               # HBM capacity
    link_bw: float                 # per-link interconnect bandwidth
    link_latency: float = 1e-6     # base per-transfer latency (seconds)
    price: float = 1.0             # relative rental cost
    mxu_efficiency: float = 0.75   # achievable fraction of peak on GEMMs
    bw_efficiency: float = 0.85    # achievable fraction of HBM bandwidth
    launch_overhead: float = 2e-6  # fixed per-kernel dispatch cost
    # L2 / on-chip cache: kernels whose working set is cache-resident
    # run at l2_bw, not HBM bw.  This is the paper's own §II-C physics —
    # FlashAttention is fast on L40s *because* its tiles live in the
    # larger L2; devices with small caches spill.  Bandwidths are
    # public-microbenchmark estimates (see Table I for capacities).
    l2_bytes: float = 0.0
    l2_bw: float = 0.0
    # Core clock (GHz): short kernels are launch/ramp-latency bound, and
    # that latency scales inversely with clock — the paper's third
    # explanation for L40s/RTX wins on small (esp. decode) kernels.
    clock_ghz: float = 1.5

    # ------------------------------------------------------------------ #
    def kernel_time(self, node: KernelNode) -> float:
        """Roofline latency of one kernel on this device."""
        # Matrix-unit work runs at MXU speed; low-intensity work is
        # bandwidth-bound; everything else uses the vector unit.
        if node.name in _MXU_PRIMS and node.intensity > 4.0:
            compute = node.flops / (self.peak_flops * self.mxu_efficiency)
        else:
            compute = node.flops / (self.vector_flops * self.mxu_efficiency)
        bw = self.hbm_bw
        if self.l2_bytes and node.bytes_accessed <= self.l2_bytes:
            bw = max(bw, self.l2_bw)
        memory = node.bytes_accessed / (bw * self.bw_efficiency)
        # flops/bytes are TOTALS across node.repeat launches (decode
        # iterations); fixed dispatch latency is paid per launch.
        launch = self.launch_overhead * 1.5 / self.clock_ghz
        return max(compute, memory) + launch * node.repeat

    def transfer_time(self, nbytes: float, peer: "DeviceSpec",
                      bw_override: Optional[float] = None,
                      repeat: int = 1) -> float:
        """``nbytes`` is the TOTAL across ``repeat`` transfers (decode
        iterations); per-transfer base latency is paid per launch."""
        bw = bw_override if bw_override else min(self.link_bw, peer.link_bw)
        return self.link_latency * repeat + nbytes / bw

    def calibrate(self, measured: Mapping[Tuple, float]) -> "CalibratedDevice":
        return CalibratedDevice(self, dict(measured))


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured wall/model service-time ratios for one serving host.

    Fitted from the machine-readable ``CALIBRATION {json}`` line that
    ``examples/serve_pipeline.py`` emits (modeled vs wall-clock TTFT /
    TPOT for the same plan): the TTFT ratio calibrates prefill-phase
    kernels, the TPOT ratio decode-phase kernels, and their geometric
    mean everything untagged.  One factor per phase is all a single
    end-to-end measurement can support — per-kernel measured profiles
    go through :meth:`DeviceSpec.calibrate` instead.
    """
    prefill_scale: float = 1.0      # wall TTFT / modeled TTFT
    decode_scale: float = 1.0       # wall TPOT / modeled TPOT

    def __post_init__(self):
        if self.prefill_scale <= 0.0 or self.decode_scale <= 0.0:
            raise ValueError("calibration scales must be positive, got "
                             f"{self.prefill_scale}/{self.decode_scale}")

    @property
    def scale(self) -> float:
        """Phase-agnostic factor (geometric mean of the two ratios)."""
        return math.sqrt(self.prefill_scale * self.decode_scale)

    def apply(self, dev) -> "ScaledDevice":
        return ScaledDevice(dev, self)

    def apply_all(self, devices) -> "list[ScaledDevice]":
        return [self.apply(d) for d in devices]


def calibrate(calibration_json) -> Calibration:
    """Fit a :class:`Calibration` from a ``CALIBRATION`` payload.

    Accepts the parsed dict, a JSON string, or the raw log line (the
    leading ``CALIBRATION `` tag is stripped).  Recognized keys are the
    ones ``examples/serve_pipeline.py`` emits —
    ``ttft_wall_over_model`` / ``tpot_wall_over_model`` — with
    ``prefill_scale`` / ``decode_scale`` accepted as spelled-out
    aliases (the form ``DeploymentSpec.calibration`` round-trips).
    """
    import json
    if isinstance(calibration_json, (str, bytes)):
        s = calibration_json.strip()
        if isinstance(s, bytes):
            s = s.decode()
        if s.startswith("CALIBRATION"):
            s = s[len("CALIBRATION"):].strip()
        obj = json.loads(s)
    else:
        obj = dict(calibration_json)
    if not isinstance(obj, dict):
        raise ValueError(f"calibration payload must be an object, "
                         f"got {type(obj).__name__}")
    pre = obj.get("ttft_wall_over_model", obj.get("prefill_scale"))
    dec = obj.get("tpot_wall_over_model", obj.get("decode_scale"))
    if pre is None and dec is None:
        raise ValueError(
            "calibration payload carries neither ttft_wall_over_model "
            f"nor tpot_wall_over_model: {sorted(obj)}")
    return Calibration(prefill_scale=float(pre if pre is not None else 1.0),
                       decode_scale=float(dec if dec is not None else 1.0))


class ScaledDevice:
    """DeviceSpec whose analytic kernel times are scaled by a measured
    :class:`Calibration` — phase-aware: prefill kernels by the TTFT
    ratio, decode kernels by the TPOT ratio, untagged kernels by the
    geometric mean.  Transfer times are NOT scaled (the calibration
    line measures compute service, not the fabric).  The derived
    ``name`` keeps calibrated placements out of the uncalibrated
    plan-cache slot (the planner keys plans by device names).
    """

    def __init__(self, spec, cal: Calibration):
        self.spec = spec
        self.cal = cal
        self.name = (f"{spec.name}*cal{cal.prefill_scale:.4g}"
                     f"/{cal.decode_scale:.4g}")

    def __getattr__(self, item):
        return getattr(self.spec, item)

    def kernel_time(self, node: KernelNode) -> float:
        t = self.spec.kernel_time(node)
        if node.phase == "prefill":
            return t * self.cal.prefill_scale
        if node.phase == "decode":
            return t * self.cal.decode_scale
        return t * self.cal.scale

    def transfer_time(self, nbytes, peer, bw_override=None, repeat=1):
        return self.spec.transfer_time(nbytes, peer, bw_override, repeat)


class CalibratedDevice:
    """DeviceSpec whose kernel times are overridden by measured profiles.

    ``measured`` maps ``KernelNode.signature()`` -> seconds.  Unmeasured
    kernels fall back to the analytic roofline.  This is the adapter for
    the paper's offline profiling pass when real hardware is available.
    """

    def __init__(self, spec: DeviceSpec, measured: Dict[Tuple, float]):
        self.spec = spec
        self.measured = measured
        self.name = spec.name + "+cal"

    def __getattr__(self, item):
        return getattr(self.spec, item)

    def kernel_time(self, node: KernelNode) -> float:
        t = self.measured.get(node.signature())
        return t if t is not None else self.spec.kernel_time(node)

    def transfer_time(self, nbytes, peer, bw_override=None, repeat=1):
        return self.spec.transfer_time(nbytes, peer, bw_override, repeat)


# --------------------------------------------------------------------- #
# TPU catalog (deployment target).  Peak numbers are public roofline
# constants; v5e matches the dry-run hardware constants mandated for the
# roofline analysis (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
# --------------------------------------------------------------------- #
TPU_V5E = DeviceSpec("tpu-v5e", peak_flops=197e12, vector_flops=12e12,
                     hbm_bw=819e9, hbm_bytes=16e9, link_bw=50e9, price=1.0)
TPU_V5P = DeviceSpec("tpu-v5p", peak_flops=459e12, vector_flops=25e12,
                     hbm_bw=2765e9, hbm_bytes=95e9, link_bw=100e9, price=3.2)
TPU_V4 = DeviceSpec("tpu-v4", peak_flops=275e12, vector_flops=17e12,
                    hbm_bw=1228e9, hbm_bytes=32e9, link_bw=50e9, price=2.1)
TPU_V6E = DeviceSpec("tpu-v6e", peak_flops=918e12, vector_flops=40e12,
                     hbm_bw=1640e9, hbm_bytes=32e9, link_bw=90e9, price=2.3)

# --------------------------------------------------------------------- #
# Paper Table I GPU catalog (for reproducing the paper's own figures).
# CUDA core TFLOPS -> vector_flops (fp32); Tensor core -> peak_flops (bf16).
# Prices normalized by L40s, as in the paper.
# --------------------------------------------------------------------- #
GPU_A100 = DeviceSpec("a100", peak_flops=312e12, vector_flops=19.5e12,
                      hbm_bw=1935e9, hbm_bytes=80e9, link_bw=25e9,
                      price=1.5, l2_bytes=40e6, l2_bw=4500e9, clock_ghz=1.41)
GPU_H100 = DeviceSpec("h100", peak_flops=989e12, vector_flops=67e12,
                      hbm_bw=3350e9, hbm_bytes=80e9, link_bw=50e9,
                      price=2.9, l2_bytes=50e6, l2_bw=7000e9, clock_ghz=1.98)
GPU_B200 = DeviceSpec("b200", peak_flops=2500e12, vector_flops=80e12,
                      hbm_bw=8000e9, hbm_bytes=192e9, link_bw=50e9,
                      price=5.0, l2_bytes=126e6, l2_bw=12000e9, clock_ghz=2.1)
GPU_L40S = DeviceSpec("l40s", peak_flops=366.5e12, vector_flops=91.6e12,
                      hbm_bw=864e9, hbm_bytes=48e9, link_bw=25e9,
                      price=1.0, l2_bytes=96e6, l2_bw=4200e9, clock_ghz=2.52)
GPU_RTX6000 = DeviceSpec("rtxpro6000", peak_flops=500e12,
                         vector_flops=120e12, hbm_bw=1597e9,
                         hbm_bytes=96e9, link_bw=25e9, price=1.2,
                         l2_bytes=126e6, l2_bw=6000e9, clock_ghz=2.6)

CATALOG: Dict[str, DeviceSpec] = {
    d.name: d for d in [
        TPU_V5E, TPU_V5P, TPU_V4, TPU_V6E,
        GPU_A100, GPU_H100, GPU_B200, GPU_L40S, GPU_RTX6000,
    ]
}

# Heterogeneous pairs used throughout benchmarks, mirroring the paper's
# local setup (A100+L40s, H100+RTX Pro 6000, B200+H100) and the TPU-native
# pairings this framework targets.
PAPER_PAIRS = [("a100", "l40s"), ("h100", "rtxpro6000"), ("b200", "h100")]
TPU_PAIRS = [("tpu-v5p", "tpu-v5e"), ("tpu-v6e", "tpu-v5e"),
             ("tpu-v4", "tpu-v5e")]

_MXU_PRIMS = frozenset({
    "dot_general", "conv_general_dilated", "mixtral_moe_gmm",
    "flash_attention", "ragged_dot",
})


# --------------------------------------------------------------------- #
# Graph-level helpers used by planner / simulator / benchmarks.
# --------------------------------------------------------------------- #
def cost_matrix(graph: KernelGraph, devices) -> "list[list[float]]":
    """t[k][g]: latency of kernel k on device g (paper's t_{k,g})."""
    return [[dev.kernel_time(n) for dev in devices] for n in graph.nodes]


def edge_cost(nbytes: float, src_dev, dst_dev,
              bw_override: Optional[float] = None,
              repeat: int = 1) -> float:
    """Paper's c_ij^{u,g} = l_{u,g} + d_ij / bw_{u,g}."""
    return src_dev.transfer_time(nbytes, dst_dev, bw_override, repeat)


def graph_time_on(graph: KernelGraph, dev) -> float:
    """Total serial execution time of the whole graph on one device."""
    return sum(dev.kernel_time(n) for n in graph.nodes)
