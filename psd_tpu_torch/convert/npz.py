"""Reader of psd_tpu's flat npz parameter files.

`psd_tpu/convert/io.py` writes a flax parameter tree to one npz, its keys
the tree paths joined by "::" (`save_params_npz`): the frozen VAE and CLIP
weights that `--vae-params`, `--clip-params` and a checkpoint's
`frozen/{vae,clip}.npz` name. `load_params_npz` gives the nested dict of
numpy arrays that `convert/from_jax.py` bridges.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

SEP = "::"


def load_params_npz(path: str | Path) -> Dict:
    """npz → the nested dict of numpy arrays it was written from."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split(SEP)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
