"""Device mesh construction helpers.

The workload's parallel axes (SURVEY.md §2.2):

* ``data``   — independent input blocks (the DP axis; the only axis the
  reference's semantics admit, since blocks deliberately share no state
  beyond raw input bytes).
* ``win``    — the search-window/distance axis inside a block (the SP/CP
  analog: the (position x distance) match table is the attention-like
  quadratic structure; sharding distances splits it column-wise and
  recombines with a max-reduce collective).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
WIN_AXIS = "win"


def make_mesh(
    n_data: int | None = None,
    n_win: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, win) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_win
    need = n_data * n_win
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_win} needs {need} devices, have {len(devices)}"
        )
    arr = np.array(devices[:need]).reshape(n_data, n_win)
    return Mesh(arr, (DATA_AXIS, WIN_AXIS))
