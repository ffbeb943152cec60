"""Native (C++) wavecore kernel tests vs the NumPy reference paths."""

import numpy as np
import pytest

from wave_fenics_tpu import native
from wave_fenics_tpu.core import geometry
from wave_fenics_tpu.core.basis import tabulate_1d
from wave_fenics_tpu.core.mesh import box_mesh

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def test_geometry_factors_match_numpy():
    m = box_mesh((3, 2, 2), (1.0, 1.1, 0.9)).to_hex_mesh()
    rng = np.random.default_rng(0)
    m = type(m)(points=m.points + 0.03 * rng.standard_normal(m.points.shape),
                cells=m.cells)
    tab = tabulate_1d(4)
    pts3 = geometry.quadrature_points_3d(tab)
    w3 = geometry.quadrature_weights_3d(tab)
    _, dphi = geometry.trilinear_tabulate(pts3)
    G, dw = native.geometry_factors(m.cell_coords(), dphi, w3)
    G2, dw2 = geometry.precompute_geometric_data(m, 4, clamp=False,
                                                 use_native=False)
    np.testing.assert_allclose(G, G2, atol=1e-14)
    np.testing.assert_allclose(dw, dw2, atol=1e-15)


def test_dedup_matches_unique():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 6, size=(5000, 3))
    ids, n = native.dedup_dofs(keys)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    assert n == len(uniq)
    # same equivalence classes
    remap = {}
    for a, b in zip(ids, inv):
        assert remap.setdefault(int(a), int(b)) == int(b)


def test_box_cells():
    cells = native.box_cells(3, 2, 2)
    ref = box_mesh((3, 2, 2), (1, 1, 1)).to_hex_mesh().cells
    np.testing.assert_array_equal(cells, ref)


def test_geometry_singular_raises():
    m = box_mesh((1, 1, 1), (1.0, 1.0, 1.0)).to_hex_mesh()
    pts = m.points.copy()
    pts[:] = 0.0  # fully degenerate
    m = type(m)(points=pts, cells=m.cells)
    tab = tabulate_1d(2)
    pts3 = geometry.quadrature_points_3d(tab)
    w3 = geometry.quadrature_weights_3d(tab)
    _, dphi = geometry.trilinear_tabulate(pts3)
    with pytest.raises(ValueError):
        native.geometry_factors(m.cell_coords(), dphi, w3)
