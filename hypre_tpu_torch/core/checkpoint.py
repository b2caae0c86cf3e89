"""Solver-state checkpointing.

Port of hypre_tpu/core/checkpoint.py.  The reference only checkpoints
matrices/vectors (HYPRE_IJMatrixPrint/Read; setup is always recomputed
— SURVEY §5).  Here the setup phase is the expensive host-side part, so
the assembled hierarchy itself is worth persisting.

Format: the reference's — a single ``np.savez`` archive, every array
leaf as a plain npy member plus one JSON string describing the object
structure.  No pickle anywhere (a tampered checkpoint must not execute
code), and the JSON decoder only instantiates dataclasses from modules
under ``hypre_tpu_torch.`` (with the dot: nothing of another package
whose name merely starts so).  Every entry point stamps and checks
FORMAT_VERSION so a stale checkpoint errors instead of being silently
reinterpreted after a layout change.

Leaves are the port's tensors, copied to host numpy on save and to the
configured device on load (their dtypes kept); numpy arrays stay numpy.
A torch dtype (a StencilOp's) is stored by name.  The port's
checkpoints hold its own formats (stencil, DIA, CSR, dense, the coarse
LU) and do not read the reference's, which hold GST-ELL leaves.
"""
from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import torch

# the port's own layout; bump when a stored dataclass changes
FORMAT_VERSION = 1
WHITELIST = "hypre_tpu_torch."
_DTYPES = {str(d): d for d in (torch.float64, torch.float32, torch.int64,
                               torch.int32, torch.bool)}


# ---------------------------------------------------------------------------
# JSON-able object graph <-> (structure, array leaves)
# ---------------------------------------------------------------------------

def _encode(obj, leaves: list):
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    if isinstance(obj, torch.dtype):
        return {"__dtype__": str(obj)}
    if isinstance(obj, torch.Tensor):
        leaves.append(obj.detach().cpu().numpy())
        return {"__leaf__": len(leaves) - 1, "tensor": True}
    if isinstance(obj, np.ndarray):
        leaves.append(obj)
        return {"__leaf__": len(leaves) - 1, "tensor": False}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(o, leaves) for o in obj]}
    if isinstance(obj, list):
        return {"__list__": [_encode(o, leaves) for o in obj]}
    if isinstance(obj, dict):
        return {"__dict__": {str(k): _encode(v, leaves)
                             for k, v in obj.items()}}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {
            "__cls__": f"{cls.__module__}:{cls.__qualname__}",
            "__fields__": {f.name: _encode(getattr(obj, f.name), leaves)
                           for f in dataclasses.fields(obj)},
        }
    raise TypeError(f"cannot checkpoint object of type {type(obj)}")


def _decode(node, leaves, device):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if not isinstance(node, dict):
        raise ValueError(f"malformed checkpoint node: {node!r}")
    if "__leaf__" in node:
        a = leaves[int(node["__leaf__"])]
        return torch.as_tensor(a, device=device) if node["tensor"] else a
    if "__dtype__" in node:
        return _DTYPES[node["__dtype__"]]
    if "__tuple__" in node:
        return tuple(_decode(o, leaves, device) for o in node["__tuple__"])
    if "__list__" in node:
        return [_decode(o, leaves, device) for o in node["__list__"]]
    if "__dict__" in node:
        return {k: _decode(v, leaves, device)
                for k, v in node["__dict__"].items()}
    if "__cls__" in node:
        modname, qualname = node["__cls__"].split(":", 1)
        if not modname.startswith(WHITELIST):
            raise ValueError(
                f"checkpoint references non-whitelisted class "
                f"{node['__cls__']}")
        cls = importlib.import_module(modname)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        if not dataclasses.is_dataclass(cls):
            raise ValueError(f"checkpoint class {node['__cls__']} is not "
                             f"a dataclass")
        fields = {k: _decode(v, leaves, device)
                  for k, v in node["__fields__"].items()}
        return cls(**fields)
    raise ValueError(f"malformed checkpoint node: {list(node)}")


def _save(path: str, meta: dict, extra_objs: dict) -> None:
    leaves: list = []
    structure = {k: _encode(v, leaves) for k, v in extra_objs.items()}
    blob = {"version": FORMAT_VERSION, "meta": meta,
            "structure": structure, "n_leaves": len(leaves)}
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    with open(path, "wb") as f:
        np.savez(f, __json__=np.frombuffer(
            json.dumps(blob).encode(), dtype=np.uint8), **arrays)


def _load(path: str):
    from hypre_tpu_torch.core.config import get_device

    with np.load(path, allow_pickle=False) as z:
        blob = json.loads(bytes(z["__json__"]).decode())
        if blob.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has format {blob.get('version')}, "
                f"expected {FORMAT_VERSION}; re-run setup")
        leaves = [z[f"leaf_{i}"] for i in range(blob["n_leaves"])]
    device = get_device()
    objs = {k: _decode(v, leaves, device)
            for k, v in blob["structure"].items()}
    return blob["meta"], objs


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def save_pytree(tree, path: str) -> None:
    """Persist any whitelisted-dataclass tree (a PFMG hierarchy, an AMG
    hierarchy, a config…)."""
    _save(path, {}, {"tree": tree})


def load_pytree(path: str):
    _meta, objs = _load(path)
    return objs["tree"]


def save_amg(amg, path: str) -> None:
    """Persist a BoomerAMG object's hierarchy + stats."""
    _save(path,
          {"level_sizes": list(amg.level_sizes),
           "level_nnz": list(amg.level_nnz)},
          {"hierarchy": amg.hierarchy, "config": amg.config})


def load_amg(path: str):
    """A BoomerAMG restored from save_amg's archive, on the configured
    device."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    meta, objs = _load(path)
    amg = BoomerAMG(objs["config"])
    amg.hierarchy = objs["hierarchy"]
    amg.level_sizes = [int(x) for x in meta["level_sizes"]]
    amg.level_nnz = [int(x) for x in meta["level_nnz"]]
    if amg.level_nnz:
        amg.operator_complexity = sum(amg.level_nnz) / amg.level_nnz[0]
        amg.grid_complexity = sum(amg.level_sizes) / amg.level_sizes[0]
    return amg
