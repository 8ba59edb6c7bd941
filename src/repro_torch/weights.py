"""Parameters from the JAX reference, as the port's tensors.

``from_jax_params`` takes the tree ``repro.models.vae.init`` returns,
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``) or
flattened as ``{"<layer>.<w|b>": array}`` (the ``.npz`` fixtures), and
returns ``{layer: {"w": tensor, "b": tensor}}`` on ``device``, so the two
packages compute on the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import device as dev


def from_jax_params(tree: Mapping[str, Any], *,
                    device: dev.DeviceLike = None) -> Dict[str, Any]:
    device = dev.resolve(device)
    nested: Dict[str, Dict[str, Any]] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            nested.setdefault(key, {}).update(value)
        else:
            layer, leaf = key.rsplit(".", 1)
            nested.setdefault(layer, {})[leaf] = value
    return {layer: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                    for k, v in p.items()}
            for layer, p in nested.items()}
