"""Parity of the port's flash attention with ray_tpu/ops/attention.py.

The port's dispatcher ops run their plain versions on CPU tensors; the
JAX package's `flash_attention` runs its Pallas kernels in interpret mode,
as its own tests run them on the CPU. Same numpy inputs on both sides.
Tolerances (fp32): out and LSE 2e-5, gradients 1e-4 — both sides sum in
fp32 in another order; bf16 runs compare within 2e-2.
"""

import zlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as ta

FWD_TOL = 2e-5
GRAD_TOL = 1e-4

# (name, q shape, kv shape, causal, block): n_rep 1/2/4, ragged tails
# (seq % block != 0), sq != skv with the causal mask aligned top-left.
CASES = [
    ("gqa2_causal", (2, 128, 4, 32), (2, 128, 2, 32), True, 64),
    ("mha_noncausal_rect", (1, 64, 2, 16), (1, 96, 2, 16), False, 32),
    ("gqa4_ragged_causal", (1, 50, 4, 16), (1, 50, 1, 16), True, 32),
    ("ragged_noncausal_rect", (1, 40, 2, 16), (1, 70, 2, 16), False, 32),
    ("causal_sq_lt_skv", (1, 48, 4, 16), (1, 80, 2, 16), True, 32),
    ("causal_sq_gt_skv", (1, 80, 2, 16), (1, 48, 2, 16), True, 32),
]


def _inputs(seed, q_shape, kv_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in (q_shape, kv_shape, kv_shape)]


def _jax_flash(jnp_arrays, causal, block, **kw):
    from ray_tpu.ops.attention import flash_attention

    return flash_attention(*jnp_arrays, causal=causal, block_q=block,
                           block_k=block, interpret=True, **kw)


def _torch(arrays, requires_grad=False):
    """numpy -> torch; ml_dtypes bfloat16 crosses as a uint16 view."""
    out = []
    for a in arrays:
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out.append(t.requires_grad_(requires_grad))
    return out


@pytest.mark.parametrize("name,q_shape,kv_shape,causal,block", CASES,
                         ids=[c[0] for c in CASES])
def test_forward_out_and_lse_match_jax(cpu_jax, name, q_shape, kv_shape,
                                       causal, block):
    import jax.numpy as jnp

    arrays = _inputs(zlib.crc32(name.encode()), q_shape, kv_shape)
    out_j, lse_j = _jax_flash([jnp.asarray(a) for a in arrays], causal,
                              block, return_lse=True)
    q, k, v = _torch(arrays)
    out, lse = ta.flash_attention(q, k, v, causal=causal, block_q=block,
                                  block_k=block, return_lse=True)
    assert out.shape == q.shape and lse.shape == (q_shape[0], q_shape[2],
                                                  q_shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    fwd_only = ta.flash_attention_fwd(q, k, v, causal=causal, block_q=block,
                                      block_k=block)
    assert torch.equal(fwd_only, out)


def _grads_vs_jax(arrays, causal, block, with_lse_ct, seed, tol):
    """dQ/dK/dV of <out, g_out> (+ <lse, g_lse>) on both sides."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    b, sq, h, _ = arrays[0].shape
    g_out = rng.standard_normal(arrays[0].shape).astype(np.float32)
    g_lse = rng.standard_normal((b, h, sq)).astype(np.float32)

    def f(q, k, v):
        out, lse = _jax_flash((q, k, v), causal, block, return_lse=True)
        loss = (out.astype(jnp.float32) * g_out).sum()
        if with_lse_ct:
            loss = loss + (lse * g_lse).sum()
        return loss

    ref = jax.grad(f, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrays])
    q, k, v = _torch(arrays, requires_grad=True)
    out, lse = ta.flash_attention(q, k, v, causal=causal, block_q=block,
                                  block_k=block, return_lse=True)
    loss = (out.float() * torch.from_numpy(g_out)).sum()
    if with_lse_ct:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    got = torch.autograd.grad(loss, (q, k, v))
    for g, r, name in zip(got, ref, "qkv"):
        assert g.dtype == q.dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("name,q_shape,kv_shape,causal,block", CASES,
                         ids=[c[0] for c in CASES])
def test_gradients_match_jax(cpu_jax, name, q_shape, kv_shape, causal,
                             block):
    """Random out cotangent; the GQA cases check the group sum of dK/dV
    (head order kvh * n_rep + g), the ragged ones that padded q rows add
    nothing and padded keys get no gradient on the JAX side."""
    arrays = _inputs(zlib.crc32(name.encode()) + 1, q_shape, kv_shape)
    _grads_vs_jax(arrays, causal, block, False, 7, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_folds_into_delta(cpu_jax, causal):
    """Gradients through both outputs: delta = rowsum(dO·O) − g_lse."""
    arrays = _inputs(21, (1, 40, 4, 16), (1, 40, 2, 16))
    _grads_vs_jax(arrays, causal, 16, True, 8, GRAD_TOL)


def test_tiled_regimes_match_jax(cpu_jax, monkeypatch):
    """The JAX package's long-context kernels (K2 forward, K4 dQ and
    dK/dV), forced at a small size by lowering its residency limits; the
    port has one kernel per pass for both regimes."""
    import jax.numpy as jnp

    from ray_tpu.ops import attention as ja

    monkeypatch.setattr(ja, "_FWD_RESIDENT_MAX_ROWS", 0)
    monkeypatch.setattr(ja, "_BWD_RESIDENT_MAX_ROWS", 0)
    arrays = _inputs(3, (1, 75, 4, 32), (1, 75, 2, 32))
    out_j, lse_j = _jax_flash([jnp.asarray(a) for a in arrays], True, 32,
                              return_lse=True)
    out, lse = ta.flash_attention(*_torch(arrays), causal=True, block_q=32,
                                  block_k=32, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    _grads_vs_jax(arrays, True, 32, True, 9, GRAD_TOL)


def test_bf16_gradients_match_jax(cpu_jax):
    """bf16 in and out: both sides compute in fp32 and take delta from the
    output rounded to bf16, so the gradients agree within bf16 rounding."""
    import ml_dtypes

    arrays = _inputs(5, (1, 64, 4, 32), (1, 64, 2, 32), ml_dtypes.bfloat16)
    _grads_vs_jax(arrays, True, 32, True, 10, 2e-2)


def test_backward_takes_delta_from_output_in_its_dtype(monkeypatch):
    """Trap: delta is rowsum(dO·O) in fp32 of the bf16 output the forward
    returned, minus g_lse, as (b, h, sq)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in _inputs(11, (1, 32, 2, 64), (1, 32, 1, 64)))
    seen = {}
    real = ta.flash_bwd_dq

    def spy(q_, k_, v_, dout, lse, delta, *args):
        seen.update(dout=dout, delta=delta)
        return real(q_, k_, v_, dout, lse, delta, *args)

    monkeypatch.setattr(ta, "flash_bwd_dq", spy)
    out, lse = ta.flash_attention(q, k, v, return_lse=True)
    g_out = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(torch.bfloat16)
    g_lse = torch.from_numpy(rng.standard_normal(lse.shape).astype(
        np.float32))
    torch.autograd.backward((out, lse), (g_out, g_lse))
    want = (g_out.float() * out.detach().float()).sum(-1).transpose(1, 2) \
        - g_lse
    assert seen["dout"].dtype == torch.bfloat16
    assert torch.equal(seen["delta"], want.contiguous())


def test_mha_reference_gradients_match_jax(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import mha_reference

    arrays = _inputs(12, (2, 24, 4, 16), (2, 24, 2, 16))
    g_out = np.random.default_rng(13).standard_normal(
        arrays[0].shape).astype(np.float32)
    ref = jax.grad(lambda q, k, v: (mha_reference(q, k, v) * g_out).sum(),
                   argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrays])
    q, k, v = _torch(arrays, requires_grad=True)
    got = torch.autograd.grad(
        (ta.mha_reference(q, k, v) * torch.from_numpy(g_out)).sum(),
        (q, k, v))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_flash_matches_mha_reference_in_the_port():
    arrays = _inputs(14, (1, 70, 4, 16), (1, 70, 2, 16))
    q, k, v = _torch(arrays)
    out = ta.attention(q, k, v, impl="flash")
    ref = ta.attention(q, k, v, impl="reference")
    torch.testing.assert_close(out, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_ops_accept_only_cpu_and_cuda():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        ta.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ta.flash_fwd(q, q, q, True, 0.125)
