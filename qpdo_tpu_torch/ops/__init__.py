"""Batched linear algebra, the linesearch, and the fused kernels' wrappers."""
