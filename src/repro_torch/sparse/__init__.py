"""Sparse substrate: CSR containers, generators, SpMV operators."""
