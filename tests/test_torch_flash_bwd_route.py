"""The bf16 flash backward passes' route on the CPU: what reaches the
kernel library, what it refuses, and the plain versions at the kernels'
tiles against the Pallas kernels of ray_tpu/ops/attention.py.

The kernels themselves (csrc/flash_attention.cu, `flash_bwd_dq_wgmma_kernel`
and `flash_bwd_dkv_wgmma_kernel`: wgmma + TMA) run only on the card:
tests/test_torch_cuda.py holds them to the plain versions there. Tolerance
of the JAX comparisons (fp32): dQ, dK and dV 1e-4, both sides sum in fp32
in another order.
"""

import contextlib
import ctypes
import types
import zlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as ta

GRAD_TOL = 1e-4


class _FakeLibrary:
    """Stands in for the ctypes library: every symbol is a recorder."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        if name in ("flash_bwd_dq_launch", "flash_bwd_dkv_launch"):
            def fn(*args):
                self.calls.append((name, args))
                return 0
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_cuda_route(monkeypatch):
    """The backward wrappers take their CUDA route on CPU tensors: the
    device check says "cuda", the stream is a fixed handle, the library
    records."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ta, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0xC0FFEE))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    return lib


def _bwd_inputs(b, sq, skv, h, hkv, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32))
    return (f(b, sq, h, d).to(dtype), f(b, skv, hkv, d).to(dtype),
            f(b, skv, hkv, d).to(dtype), f(b, sq, h, d).to(dtype),
            f(b, h, sq), f(b, h, sq))


# The backward kernels: the wrapper, its launcher's pointer count and the
# outputs it allocates (shaped like q, or like k and v).
BWD_KERNELS = [("flash_bwd_dq", 7, ("q",)),
               ("flash_bwd_dkv", 8, ("k", "v"))]


@pytest.mark.parametrize("kernel,n_ptrs,like", BWD_KERNELS,
                         ids=[c[0] for c in BWD_KERNELS])
def test_bf16_call_reaches_launch_unchanged(fake_cuda_route, kernel,
                                            n_ptrs, like):
    """The launcher's arguments: q, k, v, dout, lse, delta and the outputs
    (dq, or dk and dv) as pointers, then b, sq, skv, h, hkv, d, causal,
    scale, is_bf16, the stream; the outputs are allocated like q (or k and
    v); one launch counted."""
    q, k, v, dout, lse, delta = _bwd_inputs(2, 300, 129, 8, 2, 64)
    fn = getattr(ta, kernel)
    before = fn.launches
    got = fn(q, k, v, dout, lse, delta, True, 0.125)
    got = (got,) if torch.is_tensor(got) else got
    assert fn.launches == before + 1
    shapes = {"q": q, "k": k, "v": v}
    for out, name in zip(got, like, strict=True):
        assert out.shape == shapes[name].shape
        assert out.dtype == torch.bfloat16
    (call,) = fake_cuda_route.calls
    assert call == (kernel + "_launch", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in got), 2,
        300, 129, 8, 2, 64, 1, 0.125, 1, 0xC0FFEE))


@pytest.mark.parametrize("kernel,n_ptrs,like", BWD_KERNELS,
                         ids=[c[0] for c in BWD_KERNELS])
def test_launch_binding_unchanged(kernel, n_ptrs, like):
    lib = _build._bind(_FakeLibrary())
    p, i = ctypes.c_void_p, ctypes.c_int
    entry = getattr(lib, kernel + "_launch")
    assert entry.argtypes == [p] * n_ptrs + [i] * 7 + [ctypes.c_float, i, p]
    assert entry.restype is i


@pytest.mark.parametrize("kernel", [c[0] for c in BWD_KERNELS])
def test_refusals_come_before_any_launch(fake_cuda_route, kernel):
    """Head dim 256, a misaligned dout (TMA reads it through a tensor
    map) and an LSE of the wrong shape are refused; nothing launches."""
    fn = getattr(ta, kernel)
    q, k, v, dout, lse, delta = _bwd_inputs(1, 64, 64, 2, 1, 256)
    with pytest.raises(ValueError, match="head_dim 256"):
        fn(q, k, v, dout, lse, delta, True, 0.0625)
    q, k, v, dout, lse, delta = _bwd_inputs(1, 16, 16, 2, 1, 64)
    n = dout.numel()
    shifted = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(
        dout.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, k, v, shifted, lse, delta, True, 0.125)
    with pytest.raises(ValueError, match="lse/delta"):
        fn(q, k, v, dout, lse[:, :, :8].contiguous(), delta, True, 0.125)
    assert fake_cuda_route.calls == []


# (name, q shape, kv shape): d = 64, GQA n_rep 4, ragged tails on both
# sides of the kernel's 128-key tiles and 64-row q tiles (300 = 2 x 128 +
# 44 = 4 x 64 + 44, 129 = 128 + 1 = 2 x 64 + 1), causal with sq != skv
# both ways.
TILE_CASES = [
    ("dkv_gqa4_sq_gt_skv", (1, 300, 4, 64), (1, 129, 1, 64)),
    ("dkv_gqa4_sq_lt_skv", (1, 129, 4, 64), (1, 300, 1, 64)),
]


@pytest.mark.parametrize("name,q_shape,kv_shape", TILE_CASES,
                         ids=[c[0] for c in TILE_CASES])
def test_plain_dkv_at_kernel_tiles_matches_pallas(cpu_jax, name, q_shape,
                                                  kv_shape):
    """flash_bwd_dkv_reference with block_k = 128 and block_q = 64 (the
    bf16 kernel's tiles) against the gradients of the JAX package's
    flash_attention at the same blocks, whose dK/dV come from its Pallas
    dK/dV kernel in interpret mode: causal, top-left aligned, the JAX
    forward's out and LSE and a random out cotangent on both sides."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import flash_attention

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = [rng.standard_normal(s).astype(np.float32)
               for s in (q_shape, kv_shape, kv_shape)]
    dout = rng.standard_normal(q_shape).astype(np.float32)
    scale = q_shape[-1] ** -0.5

    def f(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=True, scale=scale,
                               block_q=64, block_k=128, interpret=True,
                               return_lse=True)

    (out_j, lse_j), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    _, dk_j, dv_j = vjp((jnp.asarray(dout), jnp.zeros_like(lse_j)))
    out_t, lse_t = (torch.from_numpy(np.array(x)) for x in (out_j, lse_j))
    dout_t = torch.from_numpy(dout)
    delta = (dout_t * out_t).sum(-1).transpose(1, 2).contiguous()
    dk, dv = ta.flash_bwd_dkv_reference(
        *map(torch.from_numpy, (q, k, v)), dout_t, lse_t, delta, True, scale,
        block_q=64, block_k=128)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


# (name, q shape, kv shape): as TILE_CASES, around the dQ kernel's 128-row
# CTAs and 64-key tiles (300 = 2 x 128 + 44 = 4 x 64 + 44, 129 = 128 + 1 =
# 2 x 64 + 1).
DQ_TILE_CASES = [
    ("dq_gqa4_sq_gt_skv", (1, 300, 4, 64), (1, 129, 1, 64)),
    ("dq_gqa4_sq_lt_skv", (1, 129, 4, 64), (1, 300, 1, 64)),
]


@pytest.mark.parametrize("name,q_shape,kv_shape", DQ_TILE_CASES,
                         ids=[c[0] for c in DQ_TILE_CASES])
def test_plain_dq_at_kernel_tiles_matches_pallas(cpu_jax, name, q_shape,
                                                 kv_shape):
    """flash_bwd_dq_reference with block_q = 128 and block_k = 64 (the
    bf16 dQ kernel's tiles) against dQ of the JAX package's
    flash_attention at the same blocks, from its Pallas dQ kernel in
    interpret mode: causal, top-left aligned, the JAX forward's out and
    LSE and a random out cotangent on both sides."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import flash_attention

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = [rng.standard_normal(s).astype(np.float32)
               for s in (q_shape, kv_shape, kv_shape)]
    dout = rng.standard_normal(q_shape).astype(np.float32)
    scale = q_shape[-1] ** -0.5

    def f(q_, k_, v_):
        return flash_attention(q_, k_, v_, causal=True, scale=scale,
                               block_q=128, block_k=64, interpret=True,
                               return_lse=True)

    (out_j, lse_j), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    dq_j, _, _ = vjp((jnp.asarray(dout), jnp.zeros_like(lse_j)))
    out_t, lse_t = (torch.from_numpy(np.array(x)) for x in (out_j, lse_j))
    dout_t = torch.from_numpy(dout)
    delta = (dout_t * out_t).sum(-1).transpose(1, 2).contiguous()
    dq = ta.flash_bwd_dq_reference(
        *map(torch.from_numpy, (q, k, v)), dout_t, lse_t, delta, True, scale,
        block_q=128, block_k=64)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
