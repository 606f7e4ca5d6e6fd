"""Compute ops: aggregation, memory reads, resizes."""
