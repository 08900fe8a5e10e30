"""Sequence parallelism over devices, and top-k database search."""
