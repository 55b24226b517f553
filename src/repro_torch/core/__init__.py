# Tessera core: kernel-granularity disaggregation for heterogeneous
# GPUs — the PyTorch counterpart of ``repro.core``.
#
#   analyzer   — torch.export ATen graph -> KernelGraph (value edges and
#                the read/write sets of in-place writes)
#   costmodel  — device catalog + roofline kernel latency
#   planner    — latency (exact min-cut) / throughput (makespan) policies
#   executor   — per-stage fx modules on logical devices (device, stream)
#   pipeline   — multi-request pipelining on prioritised CUDA streams
#   monitor    — queueing-aware online policy switching
#   marker     — phase/block/layer regions for the analyzer
#
# The discrete-event simulator is not ported yet.

from repro_torch.core.analyzer import TracedGraph, analyze, pin_nodes
from repro_torch.core.costmodel import (CATALOG, DeviceSpec, PAPER_PAIRS,
                                        TPU_PAIRS, cost_matrix)
from repro_torch.core.executor import (LogicalDevice, StagedExecutable,
                                       build_executable, logical_devices)
from repro_torch.core.graph import KernelGraph, KernelNode
from repro_torch.core.monitor import MonitorConfig, OnlineMonitor
from repro_torch.core.pipeline import PipelinedRunner
from repro_torch.core.planner import Plan, Stage, plan, replan_on_failure

__all__ = [
    "TracedGraph", "analyze", "pin_nodes", "CATALOG", "DeviceSpec",
    "PAPER_PAIRS", "TPU_PAIRS", "cost_matrix", "StagedExecutable",
    "build_executable", "LogicalDevice", "logical_devices", "KernelGraph",
    "KernelNode", "MonitorConfig", "OnlineMonitor", "PipelinedRunner",
    "Plan", "Stage", "plan", "replan_on_failure",
]
