"""Batched solving."""

from .batch import solve_batch

__all__ = ["solve_batch"]
