"""The committed reference fixtures of the port are what the reference
computes: ``tests/golden/make_torch_fixtures.py`` rebuilds them in memory
and they must equal the committed ``.npz`` files."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tests.golden import make_torch_fixtures as fx  # noqa: E402


@pytest.mark.parametrize("path,build", [
    (fx.GRID_TABLES, fx.grid_tables),
    (fx.VAE_PARAMS, fx.vae_params),
], ids=["grid_tables", "vae_fixedpoint_params"])
def test_committed_fixture_regenerates(path, build):
    fresh = build()
    with np.load(path) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for name, arr in fresh.items():
            assert committed[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(committed[name], arr, err_msg=name)
