"""Roofline accounting of the dry run's traces."""
