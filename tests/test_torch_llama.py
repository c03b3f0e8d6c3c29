"""Parity of ray_tpu_torch/models/llama.py with ray_tpu/models/llama.py.

Weights come from the JAX package's `init_params` through the port's
pytree converter. `forward` logits agree within rtol = atol = 1e-4: two
layers of fp32 matmuls whose reductions run in another order.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tl


@pytest.fixture(scope="module")
def jax_tiny(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    config = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(config, jax.random.key(0))
    return config, params, jax.tree.map(np.asarray, params)


def test_params_from_numpy_keys_and_shapes(jax_tiny):
    _, _, tree = jax_tiny
    config = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.params_from_numpy(tree, config, device="cpu")
    assert set(params) == set(tree)
    assert set(params["layers"]) == set(tree["layers"])
    for name in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(params[name].numpy(), tree[name])
    for name, arr in tree["layers"].items():
        assert tuple(params["layers"][name].shape) == arr.shape
        assert np.array_equal(params["layers"][name].numpy(), arr)


def test_init_params_matches_layout_and_count():
    config = tl.LlamaConfig.tiny(dtype=torch.float32)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = tl.init_params(config, gen, device="cpu")
    n = sum(p.numel() for p in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    assert n == config.num_params()
    assert params["layers"]["wq"].shape == (2, 64, 64)
    assert params["layers"]["w_down"].shape == (2, 128, 64)
    std = params["layers"]["w_gate"].std().item()
    assert abs(std - 1 / np.sqrt(64)) < 0.02


def test_llama3_8b_preset_matches_jax(cpu_jax):
    from ray_tpu.models import llama as jl

    j, t = jl.LlamaConfig.llama3_8b(), tl.LlamaConfig.llama3_8b()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "rope_theta", "max_seq", "norm_eps"):
        assert getattr(j, f) == getattr(t, f), f
    assert j.num_params() == t.num_params()
    assert t.dtype == torch.bfloat16


def test_forward_logits_match_jax(jax_tiny):
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    config, params, tree = jax_tiny
    tconfig = tl.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tl.params_from_numpy(tree, tconfig, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(2, 11)).astype(np.int32)
    ref = np.asarray(jl.forward(params, jnp.asarray(tokens), config))
    out = tl.forward(tparams, torch.from_numpy(tokens), tconfig)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_bf16_conversion_round_trips_bitwise(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    config = jl.LlamaConfig.tiny(dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jl.init_params(config,
                                                   jax.random.key(1)))
    assert tree["embed"].dtype.name == "bfloat16"
    params = tl.params_from_numpy(tree, tl.LlamaConfig.tiny(), device="cpu")
    for name in ("embed", "lm_head"):
        t = params[name]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                              tree[name].view(np.uint16))
    wq = params["layers"]["wq"]
    assert np.array_equal(wq.view(torch.int16).numpy().view(np.uint16),
                          tree["layers"]["wq"].view(np.uint16))
