"""Hierarchical image-VAE configurations (the Bit-Swap workload; port of
``repro.configs.hvae_img``).

Every config is a shape-free ``HVAEConfig``: the networks are fully
convolutional, so one parameter set codes any even H x W. ``small`` is
the smoke and test scale, ``base`` the training scale; each comes with
2 and 3 latent levels.

    cfg = hvae_img.get("hvae-small2")
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.hvae import HVAEConfig

SMALL2 = HVAEConfig(levels=2, ch=16, z_ch=2, n_res=1)
SMALL3 = dataclasses.replace(SMALL2, levels=3)
BASE2 = HVAEConfig(levels=2, ch=48, z_ch=4, n_res=2)
BASE3 = dataclasses.replace(BASE2, levels=3)

_REGISTRY: Dict[str, HVAEConfig] = {
    "hvae-small2": SMALL2,
    "hvae-small3": SMALL3,
    "hvae-base2": BASE2,
    "hvae-base3": BASE3,
}


def get(name: str) -> HVAEConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown hvae config {name!r}; choose from "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
