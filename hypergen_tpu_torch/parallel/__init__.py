"""Sequence parallelism: one huge genome's chunks over a list of devices."""
