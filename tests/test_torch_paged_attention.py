"""Parity of ray_tpu_torch/ops/paged_attention.py with the JAX package.

Seeded numpy inputs go through the JAX references, the Pallas kernels
(interpret mode on the CPU, as the JAX package's own tests run it) and the
port's plain versions, fp32, rtol = atol = 1e-5 (the JAX kernel's own
tolerance against its reference). On the CPU the port's entry points run
their plain versions and launch nothing; the CUDA kernels themselves are
checked on the card (tests/test_torch_cuda.py, chip_smoke.py).

Rectangular layout (K6): the Pallas kernel and the reference agree on
every row of a sequence with kv_len > 0, padding rows of a chunk
included; on a padding sequence (kv_len == 0) the kernel gives exact
zeros and the reference a uniform softmax over the gathered pages. The
engine never reads those rows; the port's CUDA kernel gives the kernel's
zeros, its plain version the reference's softmax.
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


def _rect_case(seed, q_lens, kv_lens, Bq, K=2, H=4, hd=8, ps=4,
               max_pages=6, permute=False):
    """Rectangular (S, Bq) batch: row (s, b) at position
    kv_lens[s] - q_lens[s] + b, rows b >= q_lens[s] being a chunk's
    padding; GQA G = H / K."""
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    kv_lens = np.asarray(kv_lens, np.int32)
    q_positions = np.maximum(kv_lens - np.asarray(q_lens, np.int32), 0)
    P = 1 + S * max_pages
    k_pages = rng.standard_normal((K, P, ps, hd), dtype=np.float32)
    v_pages = rng.standard_normal((K, P, ps, hd), dtype=np.float32)
    ids = (rng.permutation(S * max_pages) if permute
           else np.arange(S * max_pages))
    block_tables = (ids.reshape(S, max_pages) + 1).astype(np.int32)
    q = rng.standard_normal((S, Bq, H, hd), dtype=np.float32)
    return q, k_pages, v_pages, block_tables, kv_lens, q_positions


RECT_CASES = {
    # Split decode: one query row per sequence.
    "decode": lambda: _rect_case(1, [1, 1, 1, 1], [9, 17, 3, 24], 1),
    # Prefill chunks with padding rows (q_lens < Bq), permuted tables.
    "chunk_padding_rows": lambda: _rect_case(2, [8, 5, 2], [8, 13, 21], 8,
                                             permute=True),
    # A padding sequence (kv_len = 0) between real ones, verify-sized.
    "kv_len_0": lambda: _rect_case(3, [3, 0, 4, 1], [10, 0, 6, 2], 4,
                                   permute=True),
}


@pytest.mark.parametrize("case", sorted(RECT_CASES))
def test_rectangular_matches_jax_reference(cpu_jax, case):
    """Every row, padding sequences included, through the CPU entry point
    (the plain version); no kernel launch on CPU tensors."""
    from ray_tpu.ops import paged_attention as jpa

    args = RECT_CASES[case]()
    ref = np.asarray(jpa.ragged_paged_attention_reference(*_jax(args)))
    before = tpa.ragged_paged_attention.launches
    out = tpa.ragged_paged_attention(*_torch(args)).numpy()
    assert tpa.ragged_paged_attention.launches == before
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("case", sorted(RECT_CASES))
def test_rectangular_matches_pallas_interpret(cpu_jax, case):
    """The `_rpa_kernel` Pallas kernel in interpret mode against the
    port on the rows of sequences with kv_len > 0 (all their Bq rows)."""
    from ray_tpu.ops import paged_attention as jpa

    args = RECT_CASES[case]()
    ref = np.asarray(jpa.ragged_paged_attention(*_jax(args), interpret=True))
    out = tpa.ragged_paged_attention(*_torch(args)).numpy()
    live = args[4] > 0
    np.testing.assert_allclose(out[live], ref[live], **TOL)


def test_rectangular_kv_len_0_rows_kernel_zeros_reference_softmax(cpu_jax):
    """The documented difference: on a padding sequence the Pallas kernel
    gives exact zeros (no page is walked, acc / max(l, 1e-30)), the
    reference a uniform softmax over the gathered pages."""
    from ray_tpu.ops import paged_attention as jpa

    args = RECT_CASES["kv_len_0"]()
    pad = args[4] == 0
    kernel = np.asarray(jpa.ragged_paged_attention(*_jax(args),
                                                   interpret=True))
    ref = np.asarray(jpa.ragged_paged_attention_reference(*_jax(args)))
    assert np.array_equal(kernel[pad], np.zeros_like(kernel[pad]))
    assert np.abs(ref[pad]).max() > 0.05
    out = tpa.ragged_paged_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(out[pad], ref[pad], **TOL)


def test_unified_rejects_unaligned_token_count():
    q, kp, vp, bt, kv, qp, cu = _torch(_ragged_case(0))
    with pytest.raises(ValueError, match="multiple of q_block"):
        tpa.ragged_paged_attention_unified(q[:12], kp, vp, bt, kv, qp, cu)
