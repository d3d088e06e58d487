"""Mesh construction and sharding rules.

The 2-D ``('data', 'model')`` mesh from SURVEY.md §7 M5: batches shard
over ``data`` (primary, DP); when ``shard_model`` is on, the wide
matmuls of the encoder (frontend dense units, RNN gate projections)
shard their output dim over ``model`` (GSPMD TP). XLA inserts the
gradient psums and any reshards — we only annotate (scaling-book
recipe: pick a mesh, annotate, let XLA place the collectives).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MeshConfig


def mesh_devices(cfg: MeshConfig) -> list:
    """The devices a ('data','model') mesh of ``cfg`` spans: all global
    devices under several processes, else the first
    ``data_axis * model_axis`` local ones (``data_axis == -1``: all)."""
    devs = jax.devices()
    if jax.process_count() > 1 or cfg.data_axis == -1:
        return devs
    n = max(1, cfg.data_axis) * max(1, cfg.model_axis)
    if n > len(devs):
        raise ValueError(f"mesh {cfg.data_axis}x{cfg.model_axis} needs "
                         f"{n} devices, have {len(devs)}")
    return devs[:n]


def build_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """Devices -> Mesh[('data', 'model')].

    ``cfg.data_axis == -1`` means "all devices not used by model axis".
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    model = max(1, cfg.model_axis)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model}")
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(devices.reshape(data, model), ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batch arrays: leading (batch) dim over 'data', rest replicated."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _param_spec(path_keys: tuple, leaf, shard_model: bool) -> P:
    """Sharding rule for one parameter leaf.

    Rules (only active when shard_model):
    - 2-D matmul weights whose output dim is wide (>=256) shard that dim
      over 'model' (dense frontend w, lstm/gru wx & wh).
    - conv kernels shard the output-channel dim if wide.
    - biases shard over 'model' iff their matching weight does.
    - the 29-class head stays replicated (too narrow to shard).
    """
    if not shard_model:
        return P()
    names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path_keys]
    wide = hasattr(leaf, "shape") and leaf.ndim >= 1 and \
        leaf.shape[-1] >= 256
    if "head" in names:
        return P()
    if not wide:
        return P()
    if leaf.ndim == 1:
        return P("model")
    return P(*([None] * (leaf.ndim - 1) + ["model"]))


def param_shardings(params, mesh: Mesh, shard_model: bool = False):
    """Pytree of NamedShardings matching ``params``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    shardings = [NamedSharding(mesh, _param_spec(path, leaf, shard_model))
                 for path, leaf in flat]
    return jax.tree_util.tree_unflatten(treedef, shardings)


def state_shardings(state, mesh: Mesh, shard_model: bool = False):
    """Shardings for the full train state: params + matching opt state
    (adam moments share param shapes -> same rule), scalars replicated."""

    def one(path, leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _param_spec(path, leaf, shard_model))

    flat, treedef = jax.tree_util.tree_flatten_with_path(state)
    return jax.tree_util.tree_unflatten(
        treedef, [one(p, l) for p, l in flat])
