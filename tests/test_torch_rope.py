"""bluefog_tpu_torch rope vs the JAX rope functions on the same inputs.

The three variants (prefill ``[B, T, H, D]``, chunked ``[S, T, H, D]``
with a per-row position grid, decode rows ``[B, H, D]``) share channel
pairing and f32 internals with ``bluefog_tpu/models/transformer.py``;
they must agree to 1e-6 (both sides compute in f32; only the cos/sin
and pow implementations differ, by an ulp or so at these positions).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.models import transformer as jtf
from bluefog_tpu_torch.models import rope as trope

ATOL = 1e-6


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("D", [8, 16])
def test_apply_rope_matches_jax(D):
    x = _x((2, 12, 3, D), 0)
    pos = np.arange(12, dtype=np.int32) + 5
    want = np.asarray(jtf.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_apply_rope_grid_matches_jax():
    x = _x((3, 4, 2, 16), 1)
    pos = (np.array([[0], [7], [29]], np.int32)
           + np.arange(4, dtype=np.int32)[None])
    want = np.asarray(jtf.apply_rope_grid(jnp.asarray(x), jnp.asarray(pos)))
    got = trope.apply_rope_grid(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_apply_rope_rows_matches_jax():
    x = _x((5, 4, 8), 2)
    pos = np.array([0, 3, 17, 31, 60], np.int32)
    want = np.asarray(jtf.apply_rope_rows(jnp.asarray(x), jnp.asarray(pos)))
    got = trope.apply_rope_rows(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_rope_variants_agree_and_keep_dtype():
    """A token roped by decode rows equals the same token roped by the
    prefill variant at its position, and bf16 in gives bf16 out."""
    x = torch.from_numpy(_x((1, 6, 2, 8), 3))
    pos = torch.arange(6)
    full = trope.apply_rope(x, pos)
    rows = trope.apply_rope_rows(x[0], pos)
    torch.testing.assert_close(rows, full[0], atol=0, rtol=0)
    assert trope.apply_rope(x.bfloat16(), pos).dtype == torch.bfloat16


def test_rope_odd_head_dim_refused_like_jax():
    x = np.zeros((1, 2, 1, 7), np.float32)
    with pytest.raises(ValueError, match="even head_dim"):
        jtf.apply_rope(jnp.asarray(x), jnp.arange(2))
    with pytest.raises(ValueError, match="even head_dim"):
        trope.apply_rope(torch.from_numpy(x), torch.arange(2))
