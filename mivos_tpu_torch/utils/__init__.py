"""Tensor utilities."""
