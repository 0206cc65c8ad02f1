"""The PyTorch port's D3Q19 tables equal the JAX package's."""

import numpy as np
import pytest

from bflbm_tpu import lattice as jlat
from bflbm_tpu_torch import lattice as tlat


@pytest.mark.parametrize("name", ["C", "W", "M", "B", "M_INV",
                                  "B_REFERENCE"])
def test_table_equal(name):
    a, b = getattr(tlat, name), getattr(jlat, name)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["Q", "CS2"])
def test_constant_equal(name):
    assert getattr(tlat, name) == getattr(jlat, name)


def test_sanity_passes():
    tlat.sanity()
