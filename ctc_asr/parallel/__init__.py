"""Parallelism: device meshes, shardings, multi-host init, distributed decode.

New capability vs the reference (SURVEY.md §2c: the reference is
single-process/single-GPU with no communication layer at all):

- data parallel is primary: per-host manifest shards (data/loader.py),
  batch sharded over the ``data`` mesh axis, gradients psum'd by XLA
  under jit-with-shardings;
- GSPMD tensor parallel over the ``model`` axis for the RNN hidden /
  projection dims when the encoder exceeds one device;
- multi-host process groups via ``jax.distributed``;
- distributed beam decode shards utterances over ``data`` and the
  char-LM table over ``model`` (ops/beam.py + shard_map, see
  ``dist.py`` and ``decode_dist.py``).
"""

from .mesh import build_mesh, batch_sharding, param_shardings
from .dist import initialize_distributed

__all__ = ["build_mesh", "batch_sharding", "param_shardings",
           "initialize_distributed"]
