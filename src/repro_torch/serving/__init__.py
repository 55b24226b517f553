"""Serving: the fixed-slot continuous-batching engine and workload traces."""
