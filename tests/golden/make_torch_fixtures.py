"""Reference fixtures for the PyTorch port, written by the JAX package.

Two ``.npz`` files, both pure functions of the reference:

  * ``src/repro_torch/core/grid_tables.npz`` - ``edges_<b>`` and
    ``centres_<b>``: ``repro.core.discretize.edge_table(b)`` /
    ``centre_table(b)`` for every grid width the port codes with. The
    port gathers from these arrays instead of recomputing ``ndtri``
    (float32 ``ndtri`` is not reproducible across libraries).
  * ``tests/golden/vae_fixedpoint_params.npz`` - the parameters of the
    model behind ``bbx1_vae_fixedpoint.bin``:
    ``repro.models.vae.init(PRNGKey(0), VAEConfig(36, 24, 6))``, drawn in
    the non-partitionable threefry mode the blob was written in, flattened
    as ``<layer>.<w|b>``.

``tests/test_torch_fixtures.py`` rebuilds both in memory and checks
them against the committed files. Regenerate with::

    PYTHONPATH=src python tests/golden/make_torch_fixtures.py
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRID_TABLES = os.path.join(ROOT, "src", "repro_torch", "core",
                           "grid_tables.npz")
VAE_PARAMS = os.path.join(ROOT, "tests", "golden",
                          "vae_fixedpoint_params.npz")

#: grid widths the port ships tables for (10 is the paper's).
LAT_BITS = tuple(range(1, 13))


def grid_tables() -> Dict[str, np.ndarray]:
    from repro.core import discretize
    out = {}
    for b in LAT_BITS:
        out[f"edges_{b}"] = np.asarray(discretize.edge_table(b), np.float32)
        out[f"centres_{b}"] = np.asarray(discretize.centre_table(b),
                                         np.float32)
    return out


def vae_params() -> Dict[str, np.ndarray]:
    import jax
    from repro.models import vae
    cfg = vae.VAEConfig(input_dim=36, hidden=24, latent=6)
    with jax.threefry_partitionable(False):
        params = vae.init(jax.random.PRNGKey(0), cfg)
        return {f"{layer}.{k}": np.asarray(v)
                for layer, p in params.items() for k, v in p.items()}


def main() -> None:
    np.savez(GRID_TABLES, **grid_tables())
    np.savez(VAE_PARAMS, **vae_params())
    print("wrote", GRID_TABLES, "and", VAE_PARAMS)


if __name__ == "__main__":
    main()
