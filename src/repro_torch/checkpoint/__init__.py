"""Atomic, asynchronous checkpoints in the reference's file format."""
