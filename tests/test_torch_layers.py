"""Parity of ray_tpu_torch/ops/layers.py with ray_tpu/ops/layers.py.

The same numpy inputs (seeded) go through the JAX function and the port
on the CPU, fp32, rtol = atol = 1e-6: both are the same elementwise
formulas, so only last-ulp differences of exp/cos/rsqrt are allowed.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches_jax(cpu_jax):
    import jax.numpy as jnp

    from ray_tpu.ops import layers as jl

    rng = _rng(0)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    w = rng.standard_normal(64, dtype=np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("theta", [500000.0, 10000.0])
def test_rope_frequencies_match_jax(cpu_jax, theta):
    from ray_tpu.ops import layers as jl

    cj, sj = jl.rope_frequencies(16, 128, theta)
    ct, st = tl.rope_frequencies(16, 128, theta, device="cpu")
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


def test_rope_default_theta_is_llama3():
    import inspect

    assert inspect.signature(tl.rope_frequencies).parameters[
        "theta"].default == 500000.0


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(cpu_jax, with_positions):
    import jax.numpy as jnp

    from ray_tpu.ops import layers as jl

    rng = _rng(1)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    cj, sj = jl.rope_frequencies(16, 64)
    ct, st = tl.rope_frequencies(16, 64, device="cpu")
    pos = None
    if with_positions:
        pos = rng.integers(0, 64, size=(2, 7)).astype(np.int32)
    ref = np.asarray(jl.apply_rope(
        jnp.asarray(x), cj, sj, None if pos is None else jnp.asarray(pos)))
    out = tl.apply_rope(torch.from_numpy(x), ct, st,
                        None if pos is None else torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_apply_rope_rotates_halves_not_pairs():
    """Position 1 with head_dim 4: the pair is (x[0], x[2]), not
    (x[0], x[1]) — the half-split Llama layout."""
    cos, sin = tl.rope_frequencies(4, 2, device="cpu")
    x = torch.tensor([1.0, 0.0, 0.0, 0.0]).reshape(1, 1, 1, 4)
    out = tl.apply_rope(x, cos, sin, torch.tensor([[1]]))[0, 0, 0]
    assert out[1] == 0.0 and out[3] == 0.0
    np.testing.assert_allclose(out[2].item(), np.sin(1.0), rtol=1e-6)


def test_swiglu_matches_jax(cpu_jax):
    import jax.numpy as jnp

    from ray_tpu.ops import layers as jl

    rng = _rng(2)
    g = rng.standard_normal((4, 32), dtype=np.float32) * 4
    u = rng.standard_normal((4, 32), dtype=np.float32)
    ref = np.asarray(jl.swiglu(jnp.asarray(g), jnp.asarray(u)))
    out = tl.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
