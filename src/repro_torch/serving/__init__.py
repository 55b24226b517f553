"""Serving: the continuous-batching engine, paged KV and sessions,
workload traces, and the cluster layer (router, fabric, faults,
controller, deployment spec, sizing)."""
