"""TileMatrix + SpMVPlan serialization (checkpoint/resume).

The reference re-converts every matrix on every run (SURVEY.md §5:
no checkpointing exists). Corpus sweeps re-pay conversion constantly, so
converted TileMatrix containers can be saved to a single .npz and reloaded
without touching the converter.

Compiled SpMVPlans are serializable too, so sweeps and repeated sessions
can reload plans instead of converting and planning again. An SpMVPlan
is a pytree of arrays + static geometry fields; the writer walks the
registered dataclasses generically, so new array/static fields
round-trip without touching this module.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import TileConfig
from .tile_matrix import (COOBucket, CSRBucket, DNSBucket, DNSColBucket,
                          DNSRowBucket, ELLBucket, HYBBucket, ResidualCSR,
                          TileMatrix)

# the residual CSR is derived lazily by TileMatrix and not serialized
_BUCKETS = ("csr", "coo", "ell", "hyb", "dns", "dnsrow", "dnscol")
_BUCKET_TYPES = dict(csr=CSRBucket, coo=COOBucket, ell=ELLBucket,
                     hyb=HYBBucket, dns=DNSBucket, dnsrow=DNSRowBucket,
                     dnscol=DNSColBucket)


def save_tile_matrix(path: str, tm: TileMatrix) -> None:
    arrays = {
        "tile_ptr": tm.tile_ptr, "tile_rowidx": tm.tile_rowidx,
        "tile_columnidx": tm.tile_columnidx, "tile_nnz": tm.tile_nnz,
        "fmt": tm.fmt,
    }
    for name in _BUCKETS:
        bucket = getattr(tm, name)
        for f in dataclasses.fields(bucket):
            arrays[f"{name}.{f.name}"] = getattr(bucket, f.name)
    cfg = dataclasses.asdict(tm.config)
    cfg["value_dtype"] = np.dtype(tm.config.value_dtype).str
    meta = dict(shape=list(tm.shape), nnz=tm.nnz, tilem=tm.tilem,
                tilen=tm.tilen, config=cfg, version=1)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tile_matrix(path: str) -> TileMatrix:
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("version") != 1:
        raise ValueError(f"unknown TileMatrix file version {meta.get('version')}")
    cfg_d = meta["config"]
    cfg_d["value_dtype"] = np.dtype(cfg_d["value_dtype"])
    config = TileConfig(**cfg_d)
    buckets = {}
    for name in _BUCKETS:
        cls = _BUCKET_TYPES[name]
        kwargs = {f.name: z[f"{name}.{f.name}"]
                  for f in dataclasses.fields(cls)}
        buckets[name] = cls(**kwargs)
    return TileMatrix(
        shape=tuple(meta["shape"]), nnz=int(meta["nnz"]), config=config,
        tilem=int(meta["tilem"]), tilen=int(meta["tilen"]),
        tile_ptr=z["tile_ptr"], tile_rowidx=z["tile_rowidx"],
        tile_columnidx=z["tile_columnidx"], tile_nnz=z["tile_nnz"],
        fmt=z["fmt"], **buckets)


# ---------------------------------------------------------------------------
# SpMVPlan serialization: plans are pytrees of
# jnp arrays + static fields on @jax.tree_util.register_dataclass
# dataclasses. Walk them generically: array fields -> npz entries under
# hierarchical keys, static fields + structure -> a JSON meta tree.

_PLAN_VERSION = 2


def _plan_classes():
    from ..ops.plan import (ColEngine, CsrEngine, DenseEngine, EllEngine,
                            ResidualEngine, RowEngine, SpMVPlan)
    return {c.__name__: c for c in (SpMVPlan, DenseEngine, RowEngine,
                                    ColEngine, EllEngine, CsrEngine,
                                    ResidualEngine)}


def _flatten_node(node, key: str, arrays: dict, classes: dict):
    if node is None:
        return None
    if isinstance(node, tuple):
        return [_flatten_node(c, f"{key}.{i}", arrays, classes)
                for i, c in enumerate(node)]
    name = type(node).__name__
    if name not in classes:
        raise TypeError(f"cannot serialize plan node {name}")
    meta = {"__class__": name, "static": {}, "arrays": []}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.metadata.get("static"):
            meta["static"][f.name] = v
        elif v is None:
            continue  # absent optional array/child
        elif isinstance(v, (tuple,)) or type(v).__name__ in classes:
            meta[f.name] = _flatten_node(v, f"{key}.{f.name}", arrays,
                                         classes)
        else:
            arrays[f"{key}.{f.name}"] = np.asarray(v)
            meta["arrays"].append(f.name)
    return meta


def _unflatten_node(meta, key: str, z, classes: dict, asarray):
    if meta is None:
        return None
    if isinstance(meta, list):
        return tuple(_unflatten_node(c, f"{key}.{i}", z, classes, asarray)
                     for i, c in enumerate(meta))
    cls = classes[meta["__class__"]]
    kwargs = dict(meta["static"])
    for f in dataclasses.fields(cls):
        if f.name in kwargs:
            continue
        if f.name in meta["arrays"]:
            kwargs[f.name] = asarray(z[f"{key}.{f.name}"])
        elif f.name in meta:
            kwargs[f.name] = _unflatten_node(meta[f.name],
                                             f"{key}.{f.name}", z,
                                             classes, asarray)
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        else:
            kwargs[f.name] = None
    return cls(**kwargs)


def save_plan(path: str, plan) -> None:
    """Serialize an SpMVPlan (any dtype/geometry) to one .npz."""
    classes = _plan_classes()
    arrays: dict = {}
    tree = _flatten_node(plan, "plan", arrays, classes)
    meta = dict(version=_PLAN_VERSION, tree=tree)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_plan(path: str, device: bool = True):
    """Load an SpMVPlan saved by save_plan. `device=True` puts the
    arrays on the default JAX device (jnp.asarray); False keeps NumPy
    views (e.g. for byte-identity tests without a transfer)."""
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("version") != _PLAN_VERSION:
        raise ValueError(
            f"unknown plan file version {meta.get('version')}")
    if device:
        import jax.numpy as jnp
        asarray = jnp.asarray
    else:
        def asarray(a):
            return a
    return _unflatten_node(meta["tree"], "plan", z, _plan_classes(),
                           asarray)
