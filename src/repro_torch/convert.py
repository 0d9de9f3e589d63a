"""Carry state from the JAX package into the port.

The reference's containers hold jax arrays; a caller turns them into
numpy (``{name: np.asarray(getattr(obj, name))}``) and these functions
build the port's containers from that, so one operand can feed both
packages.  This module imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gse import GSEPacked
from repro_torch.core.precision import MonitorParams
from repro_torch.sparse.csr import CSR, GSECSR, csr_row_plan

__all__ = ["gsecsr_from_repro", "csr_from_repro", "monitor_params_from_repro",
           "params_from_repro"]

_GSECSR_DTYPES = {
    "rowptr": np.int32, "colpak": np.uint32, "head": np.uint16,
    "tail1": np.uint16, "tail2": np.uint32, "table": np.int32,
    "row_ids": np.int32,
}
_CSR_DTYPES = {"rowptr": np.int32, "col": np.int32, "val": np.float64,
               "row_ids": np.int32}


def _tensors(arrays: dict, dtypes: dict, device) -> dict:
    host = {name: np.asarray(arrays[name]) for name in dtypes}
    for name, dtype in dtypes.items():
        if host[name].dtype != dtype:
            raise TypeError(f"{name} must be {np.dtype(dtype).name}, "
                            f"got {host[name].dtype}")
    return {name: torch.from_numpy(np.array(a)).to(device)
            for name, a in host.items()}


def gsecsr_from_repro(arrays: dict, ei_bit: int, shape, device="cuda") -> GSECSR:
    """A port ``GSECSR`` from the numpy arrays of a reference ``GSECSR``
    (keys ``rowptr colpak head tail1 tail2 table row_ids``), with the row
    plan of kernel A64 (``csr_row_plan``), as ``pack_csr`` gives it."""
    t = _tensors(arrays, _GSECSR_DTYPES, device)
    return GSECSR(**t, ei_bit=int(ei_bit), shape=tuple(int(s) for s in shape),
                  row_plan=csr_row_plan(t["rowptr"]))


def csr_from_repro(arrays: dict, shape, device="cuda") -> CSR:
    """A port ``CSR`` from the numpy arrays of a reference ``CSR`` (keys
    ``rowptr col val row_ids``)."""
    return CSR(**_tensors(arrays, _CSR_DTYPES, device),
               shape=tuple(int(s) for s in shape))


def monitor_params_from_repro(params) -> MonitorParams:
    """The port's ``MonitorParams`` with every field of a reference
    ``MonitorParams`` (any object with the same attribute names)."""
    return MonitorParams(**{f.name: getattr(params, f.name)
                            for f in dataclasses.fields(MonitorParams)})


# Segment dtypes of a ``gse_serve`` weight dict and of a ``GSEPacked``.
_SEGMENT_DTYPES = {"head": np.uint16, "tail1": np.uint16, "tail2": np.uint32,
                   "table": np.int32}
_PACKED_FIELDS = ("table", "head", "tail1", "tail2", "ei_bit", "frac_bits")
_FLOAT_DTYPES = ("float32", "float64", "float16", "bfloat16")


def _leaf_tensor(a, where: str, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16).to(device)
    if a.dtype.name not in _FLOAT_DTYPES:
        raise TypeError(f"{where}: a dense leaf must be floating, got "
                        f"{a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def _segment(a, name: str, where: str, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != _SEGMENT_DTYPES[name]:
        raise TypeError(f"{where}/{name} must be "
                        f"{np.dtype(_SEGMENT_DTYPES[name]).name}, got "
                        f"{a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def params_from_repro(tree, device="cuda"):
    """The port's params tree from a reference params tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), on ``device``.

    Carries dense float leaves (bf16 included), ``gse_serve`` segment dicts
    (``head``/``tail1`` u16, ``table`` i32, ``tail2`` u32 at tag 3) and the
    ``GSEPacked`` leaves of ``quantize_tree`` (any object with their
    fields), checking every dtype.
    """

    def walk(node, where):
        if all(hasattr(node, f) for f in _PACKED_FIELDS):
            return GSEPacked(**{f: _segment(getattr(node, f), f, where,
                                            device)
                                for f in ("table", "head", "tail1", "tail2")},
                             ei_bit=int(node.ei_bit),
                             frac_bits=int(node.frac_bits))
        if isinstance(node, dict):
            if "head" in node:
                return {k: _segment(v, k, where, device)
                        for k, v in node.items()}
            return {k: walk(v, f"{where}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{where}/{i}") for i, v in enumerate(node)]
        return _leaf_tensor(node, where, device)

    return walk(tree, "")
