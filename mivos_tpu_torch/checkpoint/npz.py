"""Reader of the JAX package's single-file .npz weight snapshots (the
port's own copy of the loading half of mivos_tpu/checkpoint/npz.py,
numpy only): a flax parameter tree flattened to '/'-joined keys.
`state_dict_from_flax` (checkpoint/from_jax.py) turns a loaded tree into
the port's state_dict."""
from __future__ import annotations

from typing import Dict

import numpy as np


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params_npz(path: str) -> Dict:
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
