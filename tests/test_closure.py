"""hoisted_jit: closed-over tables must become runtime arguments, not
HLO literals (large literals bloat compile time and the executable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wave_fenics_tpu.utils.closure import hoisted_jit


def test_hoists_large_consts_out_of_hlo():
    big = np.arange(1 << 20, dtype=np.float32)  # 4 MB
    x = jnp.ones((1 << 20,), jnp.float32)
    hf = hoisted_jit(lambda v: (v * big).sum(), x)
    assert hf.n_hoisted == 1
    assert float(hf(x)) == pytest.approx(float((x * big).sum()))
    txt = hf.jitted.lower(hf.consts, x).as_text()
    assert len(txt) < 1 << 16  # literal would be ~8 MB of text


def test_small_consts_stay_embedded():
    small = np.arange(8, dtype=np.float32)
    x = jnp.ones((8,), jnp.float32)
    hf = hoisted_jit(lambda v: v + small, x)
    assert hf.n_hoisted == 0
    np.testing.assert_allclose(np.asarray(hf(x)), 1.0 + small)


def test_pytree_args_and_multiple_outputs():
    big = np.arange(1 << 16, dtype=np.float64)
    x = jnp.ones((1 << 16,), jnp.float64)
    hg = hoisted_jit(
        lambda a, b: (a["u"] * big + b, (a["u"] - b).sum()),
        {"u": x}, x,
    )
    y1, y2 = hg({"u": x}, x)
    np.testing.assert_allclose(np.asarray(y1), big + 1.0)
    assert float(y2) == 0.0


def test_general_operator_hlo_stays_small():
    """The indexed general apply's tables (dofmap, ELL scatter table,
    geometric factors) must not appear as HLO literals under
    hoisted_jit."""
    from wave_fenics_tpu.core.dofmap import build_dofmap
    from wave_fenics_tpu.core.mesh import box_mesh
    from wave_fenics_tpu.ops.operators import GeneralOperators

    p = 2
    hm = box_mesh((4, 3, 3), (1.0, 1.0, 1.0)).to_hex_mesh()
    dofs = build_dofmap(hm, p)
    ops = GeneralOperators(hm, dofs, dtype=jnp.float64)
    apply = lambda a: ops.stiffness(a, 2.0)
    x = jnp.ones((dofs.ndofs,), jnp.float64)
    hf = hoisted_jit(apply, x, min_bytes=1 << 10)
    assert hf.n_hoisted >= 3  # dofmap, ELL table, geometric factors
    txt = hf.jitted.lower(hf.consts, x).as_text()
    assert len(txt) < 1 << 16
    np.testing.assert_allclose(np.asarray(hf(x)), np.asarray(apply(x)),
                               rtol=1e-13)
