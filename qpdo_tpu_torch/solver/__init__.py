"""Solver core of the PyTorch port."""
