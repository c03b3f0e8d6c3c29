"""Parity of ray_tpu_torch/ops/paged_attention.py with the JAX package.

Seeded numpy inputs go through the JAX references, the Pallas unified
kernel (interpret mode on the CPU, as the JAX package's own tests run it)
and the port's plain versions, fp32, rtol = atol = 1e-5 (the JAX kernel's
own tolerance against its reference). On the CPU the port's entry point
runs its plain version and launches nothing; the CUDA kernel itself is
checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _ragged_case(seed=0, S=3, K=2, H=4, hd=8, ps=4, max_pages=6,
                 q_lens=(1, 3, 8), kv_lens=(9, 11, 8), T=16):
    """The mixed batch of tests/test_llm_unified.py: one decode row, one
    3-row span, one 8-row prefill slice, plus flat-tail padding."""
    rng = np.random.default_rng(seed)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    kv_lens = np.asarray(kv_lens, np.int32)
    q_positions = np.maximum(kv_lens - np.asarray(q_lens, np.int32), 0)
    P = 1 + S * max_pages
    k_pages = rng.standard_normal((K, P, ps, hd), dtype=np.float32)
    v_pages = rng.standard_normal((K, P, ps, hd), dtype=np.float32)
    block_tables = np.arange(S * max_pages, dtype=np.int32).reshape(
        S, max_pages) + 1
    q = rng.standard_normal((T, H, hd), dtype=np.float32)
    return q, k_pages, v_pages, block_tables, kv_lens, q_positions, cu


def _kv0_case(seed=3):
    """A padding sequence (kv_len = 0, no tokens) between two real ones,
    with permuted (non-contiguous) page tables."""
    args = list(_ragged_case(seed, S=3, q_lens=(2, 0, 5),
                             kv_lens=(6, 0, 13)))
    rng = np.random.default_rng(seed)
    args[3] = rng.permutation(args[3].size).astype(np.int32).reshape(
        args[3].shape) + 1
    return tuple(args)


CASES = {"mixed": lambda: _ragged_case(0), "mixed_seed7":
         lambda: _ragged_case(7), "kv_len_0": _kv0_case}


def _jax(args):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in args)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unified_reference_matches_jax(cpu_jax, case):
    from ray_tpu.ops import paged_attention as jpa

    args = CASES[case]()
    ref = np.asarray(jpa.ragged_paged_attention_unified_reference(
        *_jax(args)))
    out = tpa.ragged_paged_attention_unified_reference(*_torch(args))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unified_matches_pallas_interpret(cpu_jax, case):
    from ray_tpu.ops import paged_attention as jpa

    args = CASES[case]()
    cu = args[-1]
    ref = np.asarray(jpa.ragged_paged_attention_unified(*_jax(args)))
    out = tpa.ragged_paged_attention_unified(*_torch(args)).numpy()
    n = cu[-1]
    np.testing.assert_allclose(out[:n], ref[:n], **TOL)
    assert np.array_equal(out[n:], np.zeros_like(out[n:])), \
        "padding rows must be exact zeros"


def test_rectangular_reference_matches_jax(cpu_jax):
    from ray_tpu.ops import paged_attention as jpa

    q, kp, vp, bt, kv_lens, _, _ = _ragged_case(5)
    rng = np.random.default_rng(5)
    qr = rng.standard_normal((3, 4, 4, 8), dtype=np.float32)
    q_pos = np.maximum(kv_lens - 4, 0).astype(np.int32)
    args = (qr, kp, vp, bt, kv_lens, q_pos)
    ref = np.asarray(jpa.ragged_paged_attention_reference(*_jax(args)))
    out = tpa.ragged_paged_attention_reference(*_torch(args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("cu", [[0, 1, 4, 12], [0, 0, 5, 5], [0, 7, 7, 16]])
def test_token_seq_ids_equal_jax(cpu_jax, cu):
    import jax.numpy as jnp

    from ray_tpu.ops import paged_attention as jpa

    cu = np.asarray(cu, np.int32)
    ref = np.asarray(jpa.token_seq_ids(jnp.asarray(cu), 16, 3))
    out = tpa.token_seq_ids(torch.from_numpy(cu), 16, 3).numpy()
    assert np.array_equal(out, ref)


def test_padding_rows_exact_zero_and_no_cpu_launch():
    """CPU tensors run the plain version: padding rows are exact zeros and
    the kernel's launch count does not move."""
    args = _torch(_ragged_case(11))
    before = tpa.ragged_paged_attention_unified.launches
    out = tpa.ragged_paged_attention_unified(*args)
    assert tpa.ragged_paged_attention_unified.launches == before
    n = int(args[-1][-1])
    assert torch.count_nonzero(out[n:]) == 0
    assert torch.isfinite(out).all()


def test_unified_rejects_unaligned_token_count():
    q, kp, vp, bt, kv, qp, cu = _torch(_ragged_case(0))
    with pytest.raises(ValueError, match="multiple of q_block"):
        tpa.ragged_paged_attention_unified(q[:12], kp, vp, bt, kv, qp, cu)
