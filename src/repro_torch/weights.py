"""Parameters from the JAX reference, as the port's tensors.

``from_jax_params`` takes a tree ``init`` of the reference returns,
converted to numpy (``jax.tree_util.tree_map(np.asarray, params)``): any
nesting of dicts and lists, such as the VAE's ``{layer: {w, b}}`` or the
HVAE's stages with their list of residual blocks. A top-level key
``"<layer>.<w|b>"`` with an array value (the flat form the ``.npz``
fixtures store) is read as ``{layer: {w|b: array}}``. It returns the same
tree of float32 tensors on ``device``, so the two packages compute on the
same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import device as dev


def from_jax_params(tree: Mapping[str, Any], *,
                    device: dev.DeviceLike = None) -> Dict[str, Any]:
    device = dev.resolve(device)
    nested: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, (Mapping, list, tuple)) or "." not in key:
            if isinstance(nested.get(key), dict):
                nested[key].update(value)
            else:
                nested[key] = value
        else:
            layer, leaf = key.rsplit(".", 1)
            nested.setdefault(layer, {})[leaf] = value

    def convert(t: Any) -> Any:
        if isinstance(t, Mapping):
            return {k: convert(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [convert(v) for v in t]
        return torch.from_numpy(np.array(t, np.float32)).to(device)

    return convert(nested)
