"""Iterative solvers with stepped mixed precision (paper Section III.D)."""
