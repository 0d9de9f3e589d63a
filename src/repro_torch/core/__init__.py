"""Core of the paper's contribution: GSE-SEM format + stepped precision."""
