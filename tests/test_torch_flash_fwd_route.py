"""The bf16 flash forward's route on the CPU: what reaches the kernel
library, the TMA alignment rule, and the plain version at the kernel's
128-row, 128-key tiles against ray_tpu/ops/attention.py.

The kernel itself (csrc/flash_attention.cu, wgmma + TMA) runs only on the
card: tests/test_torch_cuda.py holds it to the plain version there.
Tolerance of the JAX comparison (fp32): out and LSE 2e-5, both sides sum
in fp32 in another order.
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

FWD_TOL = 2e-5


class _FakeLibrary:
    """Stands in for the ctypes library: every symbol is a recorder."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        if name == "flash_fwd_launch":
            fn = _Recorder(self.calls)
        setattr(self, name, fn)
        return fn


class _Recorder:
    def __init__(self, calls):
        self.calls, self.argtypes, self.restype = calls, None, None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_cuda_route(monkeypatch):
    """flash_fwd takes its CUDA route on CPU tensors: the device check
    says "cuda", the stream is a fixed handle, the library records."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ta, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0xC0FFEE))
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    return lib


@pytest.mark.parametrize("with_lse", [True, False])
def test_bf16_call_reaches_flash_fwd_launch_unchanged(fake_cuda_route,
                                                      with_lse):
    """The launcher's arguments: q, k, v, out, lse (None without) as
    pointers, then b, sq, skv, h, hkv, d, causal, scale, is_bf16, the
    stream; one launch counted."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16) for s in ((2, 300, 8, 64),
                                             (2, 129, 2, 64),
                                             (2, 129, 2, 64)))
    before = ta.flash_fwd.launches
    out, lse = ta.flash_fwd(q, k, v, True, 0.125, with_lse=with_lse)
    assert ta.flash_fwd.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == ((2, 8, 300) if with_lse else (0,))
    (args,) = fake_cuda_route.calls
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if with_lse else None, 2, 300, 129, 8, 2,
                    64, 1, 0.125, 1, 0xC0FFEE)


def test_flash_fwd_launch_binding_unchanged():
    lib = _build._bind(_FakeLibrary())
    p, i = ctypes.c_void_p, ctypes.c_int
    assert lib.flash_fwd_launch.argtypes == [p] * 5 + [i] * 7 + [
        ctypes.c_float, i, p]
    assert lib.flash_fwd_launch.restype is i


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


@pytest.mark.parametrize("shape", [(4, 2048, 16, 128), (4, 2048, 8, 128),
                                   (1, 2048, 32, 128), (1, 1000, 16, 128),
                                   (1, 1000, 8, 64)],
                         ids=["train_q", "train_kv", "gqa4_q", "ragged_q",
                              "ragged_kv_d64"])
def test_tma_rule_accepts_the_main_path_shapes(shape):
    strides = _contiguous_strides(shape)
    for elem in (2, 4):
        assert ta.tma_aligned(0x7F0000000100, strides, elem)


def test_tma_rule_refuses_misaligned_base_or_stride():
    strides = _contiguous_strides((1, 1000, 16, 128))
    assert not ta.tma_aligned(0x7F0000000108, strides, 2)   # base 8 bytes off
    assert not ta.tma_aligned(0x7F0000000102, strides, 2)
    # A row of 68 bf16 (136 bytes) is no multiple of 16 bytes.
    assert not ta.tma_aligned(0x7F0000000100, (68 * 10, 68, 68, 1), 2)
    assert ta.tma_aligned(0x7F0000000100, (72 * 10, 72, 72, 1), 2)


def test_kernel_args_refuse_a_misaligned_tensor():
    """_check_kernel_args applies the rule to every input: a bf16 q one
    element past an aligned base is refused before any launch."""
    n = 1 * 16 * 2 * 64
    q = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(1, 16, 2, 64)
    k = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        ta._check_kernel_args(q, k, k)
    ta._check_kernel_args(k, k, k)


# (name, q shape, kv shape): d = 64, GQA n_rep 4, ragged tails on both
# sides of the kernel's 128-row and 128-key tiles (300 = 2 x 128 + 44,
# 129 = 128 + 1), causal with sq != skv both ways.
TILE_CASES = [
    ("gqa4_ragged_sq_gt_skv", (1, 300, 4, 64), (1, 129, 1, 64)),
    ("gqa4_ragged_sq_lt_skv", (1, 129, 4, 64), (1, 300, 1, 64)),
]


@pytest.mark.parametrize("name,q_shape,kv_shape", TILE_CASES,
                         ids=[c[0] for c in TILE_CASES])
def test_plain_version_at_kernel_tiles_matches_jax(cpu_jax, name, q_shape,
                                                   kv_shape):
    """flash_fwd_reference with block_q = block_k = 128 (the bf16
    kernel's tiles) against the JAX package's flash_attention at the same
    blocks in interpret mode: causal, top-left aligned."""
    import jax.numpy as jnp

    from ray_tpu.ops.attention import flash_attention

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (q_shape, kv_shape, kv_shape)]
    out_j, lse_j = flash_attention(*[jnp.asarray(a) for a in arrays],
                                   causal=True, block_q=128, block_k=128,
                                   interpret=True, return_lse=True)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out, lse = ta.flash_fwd_reference(q, k, v, True, q_shape[-1] ** -0.5,
                                      block_q=128, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=FWD_TOL,
                               atol=FWD_TOL)
