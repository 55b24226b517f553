"""Fault-tolerant runtime glue: failure detection, elastic re-planning,
straggler deadlines.

Tessera-native elasticity: because the unit of placement is a
*kernel*, losing a device never requires re-architecting the
parallelism — the planner simply re-solves placement over the
surviving device set (``replan_on_failure``), pinned state is
re-homed, and the executor is rebuilt.  This is strictly more flexible
than phase/block disaggregation, whose recovery unit is an entire
phase pool.

Health primitives live in :mod:`repro_torch.serving.faults` (the
fault-tolerance layer serving both the DES and the live engines);
``DeviceHealth`` is re-exported here for compatibility — it keeps its
historical ``alive``/``fail``/``lost`` surface but now latches a
per-device circuit breaker (``serving.faults.GroupHealth``) on
failure, so runtime device loss and serving-layer health speak the
same language.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Set

from repro_torch.core import planner as planner_lib
from repro_torch.core.analyzer import TracedGraph
from repro_torch.core.executor import (LogicalDevice, StagedExecutable,
                                       build_executable, logical_devices)
from repro_torch.core.planner import Plan
from repro_torch.serving.faults import DeviceHealth

__all__ = ["DeviceHealth", "ElasticExecutor"]


class ElasticExecutor:
    """Disaggregated executor that survives device loss.

    On ``mark_failed(i)`` the placement is re-solved over survivors and
    stages recompiled; in-flight pure stages are simply re-executed (the
    same idempotence that powers straggler re-execution).

    ``devices`` are the logical devices the plan's device slots map
    onto (``core.executor.logical_devices``; default one per spec on
    the card, each with a stream of its own).
    """

    def __init__(self, traced: TracedGraph, device_specs,
                 devices: Optional[Sequence[LogicalDevice]] = None,
                 policy: str = "throughput"):
        self.traced = traced
        self.specs = list(device_specs)
        self.devices = list(devices if devices is not None
                            else logical_devices(len(self.specs)))
        self.policy = policy
        self.health = DeviceHealth([True] * len(device_specs))
        self.plan = planner_lib.plan(traced.graph, self.specs,
                                     policy=policy)
        self.replans = 0
        self._rebuild()

    def _rebuild(self) -> None:
        alive_idx = [i for i, a in enumerate(self.health.alive) if a]
        spec_map = [self.specs[i] for i in alive_idx]
        dev_map = [self.devices[i % len(self.devices)]
                   for i in alive_idx]
        if len(alive_idx) < len(self.specs):
            self.plan = planner_lib.replan_on_failure(
                self.traced.graph, self.specs, self.health.lost(),
                self.plan, cache=False)
        self.exe = build_executable(self.traced, self.plan, dev_map)

    def mark_failed(self, idx: int) -> None:
        self.health.fail(idx)
        self.replans += 1
        self._rebuild()

    def __call__(self, *args, **kwargs):
        return self.exe(*args, **kwargs)
