"""Host-side utilities of the solver (the iteration table)."""
