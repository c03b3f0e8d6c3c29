"""Parity of the port's in-process pipeline (ray_tpu_torch.parallel.pipeline)
with the JAX package's parallel/pipeline.py.

The schedules equal JAX's op for op over a grid of (stages, interleave,
microbatches) that includes m % p != 0; the partitioning round-trips;
each stage's forward (1e-5) and its pullback (1e-4) equal the JAX stage
programs on the same numpy inputs; `LocalPipeline`'s losses (1e-5
relative) and merged parameters after three AdamW steps (1e-4 absolute)
equal the JAX `LocalPipeline` with `optax.adamw` at 2 stages, 4 stages
and 2 x interleave 2 (JAX on `jax.devices()[:n]`, the port on "cpu"
stages), and the port's one-program `train/step.py` step.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import pipeline as tp
from ray_tpu_torch.train import optim
from ray_tpu_torch.train.step import make_step

LR = 1e-3
STEPS = 3


def _ops(seq):
    return [(o.kind, o.stage, o.microbatch) for o in seq]


def _per_queue(queues):
    return [_ops(q) for q in queues]


# (p, v, m): m % p != 0 in (2, 1, 3), (3, 1, 4), (4, 1, 5), (2, 2, 5),
# (3, 2, 7) and (4, 2, 9); (3, 2, 7) and (2, 2, 5) take the interleaved
# fallback of submission_order.
GRID = [(1, 1, 1), (1, 1, 3), (2, 1, 2), (2, 1, 3), (2, 1, 8), (3, 1, 4),
        (3, 1, 6), (4, 1, 4), (4, 1, 5), (4, 1, 8), (2, 2, 4), (2, 2, 5),
        (2, 2, 8), (3, 2, 6), (3, 2, 7), (4, 2, 8), (4, 2, 9), (2, 3, 6),
        (2, 4, 8)]


@pytest.mark.parametrize("p,v,m", GRID)
def test_schedules_equal_jax_op_for_op(p, v, m):
    from ray_tpu.parallel import pipeline as jp

    if v == 1:
        assert _per_queue(tp.one_f_one_b(p, m)) == \
            _per_queue(jp.one_f_one_b(p, m))
        assert _ops(tp.global_order(p, m)) == _ops(jp.global_order(p, m))
    if m >= p * v:
        assert _per_queue(tp.virtual_stage_schedule(p, v, m)) == \
            _per_queue(jp.virtual_stage_schedule(p, v, m))
        assert _ops(tp.submission_order(p, v, m)) == \
            _ops(jp.submission_order(p, v, m))
    if m % p == 0:
        mine = tp.megatron_interleaved_schedule(p, v, m)
        assert _per_queue(mine) == \
            _per_queue(jp.megatron_interleaved_schedule(p, v, m))
        assert _ops(tp.linearize(mine, p * v)) == _ops(
            jp.linearize(jp.megatron_interleaved_schedule(p, v, m), p * v))
    else:
        with pytest.raises(ValueError, match="n_microbatches % n_devices"):
            tp.megatron_interleaved_schedule(p, v, m)


def test_schedule_refusals_and_layer_ranges():
    from ray_tpu.parallel import pipeline as jp

    with pytest.raises(ValueError, match="at least n_stages"):
        tp.one_f_one_b(4, 3)
    bad = [[tp.PipeOp("bwd", 0, 0), tp.PipeOp("fwd", 0, 0)]]
    with pytest.raises(RuntimeError, match="deadlocked"):
        tp.linearize(bad, 1)
    for n_layers in range(1, 15):
        for n_stages in range(1, 9):
            assert tp.stage_layer_ranges(n_layers, n_stages) == \
                jp.stage_layer_ranges(n_layers, n_stages)


@pytest.fixture(scope="module")
def setup(cpu_jax):
    """tests/test_pipeline.py's configuration on both packages: tiny, 4
    layers, max_seq 32, fp32, no remat; 8 sequences of 33 tokens."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jc = jl.LlamaConfig.tiny(n_layers=4, max_seq=32, dtype=jnp.float32,
                             remat=False)
    tc = tl.LlamaConfig.tiny(n_layers=4, max_seq=32, dtype=torch.float32,
                             remat=False)
    params = jl.init_params(jc, jax.random.key(0))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (8, 33)).astype(np.int32)
    return jc, tc, params, jax.tree.map(np.asarray, params), tokens


def _port_params(tree, tc):
    return tl.params_from_numpy(tree, tc, device="cpu")


def _jax_flat(tree):
    import jax

    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_flat(tree):
    return {path: t.detach().numpy() for path, t in optim.leaves(tree)}


def _assert_tree_close(got, want, atol=0.0, rel=0.0):
    """got: the port's tree; want: a JAX tree or a flat dict of arrays.
    Each leaf within atol + rel x its largest magnitude."""
    got = _port_flat(got)
    want = want if all(isinstance(v, np.ndarray) for v in want.values()) \
        else _jax_flat(want)
    assert set(got) == set(want)
    for path in want:
        tol = atol + rel * float(np.abs(want[path]).max())
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_split_merge_round_trip(setup, n_stages):
    _, tc, _, tree, _ = setup
    params = _port_params(tree, tc)
    stages = tp.split_params(params, n_stages)
    assert "embed" in stages[0] and "lm_head" in stages[-1]
    assert sum(st["layers"]["wq"].shape[0] for st in stages) == 4
    merged = tp.merge_params(stages)
    for (pa, a), (pb, b) in zip(optim.leaves(params), optim.leaves(merged)):
        assert pa == pb
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("n_stages", [2, 3])
def test_stage_programs_equal_jax(setup, n_stages):
    """Each stage's forward (1e-5) and pullback (dp and dx within 1e-4 x
    each leaf's largest magnitude: fp32 sums in another order) on the same
    inputs and cotangents as the JAX stage programs; the last stage's loss
    (1e-5 relative) and its gradients."""
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline as jp

    jc, tc, params, tree, tokens = setup
    jstages = jp.split_params(params, n_stages)
    tstages = [{k: v for k, v in st.items()} for st in
               tp.split_params(_port_params(tree, tc), n_stages)]
    for st in tstages:
        for _, t in optim.leaves(st):
            t.requires_grad_(True)
    jfwd, jbwd = jp.build_chunk_programs(jc, range(n_stages), n_stages)
    tfwd, tbwd = tp.build_chunk_programs(tc, range(n_stages), n_stages)
    rng = np.random.default_rng(n_stages)
    inputs, targets = tokens[:2, :-1], tokens[:2, 1:]
    for s in range(n_stages):
        if s == 0:
            x = inputs
        else:
            x = rng.standard_normal((2, 32, tc.d_model)).astype(np.float32)
        tx = torch.from_numpy(x).long() if s == 0 else torch.from_numpy(x)
        if s == n_stages - 1:
            jl, (jdp, jdx) = jbwd[s](jstages[s], jnp.asarray(x),
                                     jnp.asarray(targets))
            tloss, (tdp, tdx) = tbwd[s](tstages[s], tx,
                                        torch.from_numpy(targets).long())
            np.testing.assert_allclose(tloss.item(), float(jl), rtol=1e-5)
        else:
            jout = jfwd[s](jstages[s], jnp.asarray(x))
            tout = tfwd[s](tstages[s], tx)
            assert not tout.requires_grad
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       rtol=1e-5, atol=1e-5)
            g = rng.standard_normal(tout.shape).astype(np.float32)
            jdp, jdx = jbwd[s](jstages[s], jnp.asarray(x), jnp.asarray(g))
            tdp, tdx = tbwd[s](tstages[s], tx, torch.from_numpy(g))
        _assert_tree_close(tdp, jdp, rel=1e-4)
        if s == 0:
            assert tdx is None
        else:
            _assert_tree_close({"x": tdx}, {"x": np.asarray(jdx)}, rel=1e-4)


def _jax_pipeline(setup, n_stages, interleave, n_mb):
    import jax
    import optax

    from ray_tpu.parallel.pipeline import LocalPipeline

    jc, _, params, _, tokens = setup
    pipe = LocalPipeline(jc, params, n_stages=n_stages,
                         optimizer=optax.adamw(LR),
                         devices=jax.devices()[:n_stages],
                         interleave=interleave)
    losses = [pipe.train_step(tokens, n_microbatches=n_mb)["loss"]
              for _ in range(STEPS)]
    return losses, pipe.merged_params()


def _port_pipeline(setup, n_stages, interleave, n_mb):
    _, tc, _, tree, tokens = setup
    params = _port_params(tree, tc)
    pipe = tp.LocalPipeline(tc, params, n_stages, optim.adamw(LR),
                            devices=["cpu"] * n_stages,
                            interleave=interleave)
    assert len(pipe.stage_params) == n_stages * interleave
    batch = torch.from_numpy(tokens).long()
    losses = [pipe.train_step(batch, n_microbatches=n_mb)["loss"]
              for _ in range(STEPS)]
    # The stages hold copies: the caller's parameters did not move.
    np.testing.assert_array_equal(params["lm_head"].numpy(),
                                  tree["lm_head"])
    return losses, pipe.merged_params(), pipe


@pytest.mark.parametrize("n_stages,interleave", [(2, 1), (4, 1), (2, 2)])
def test_local_pipeline_equals_jax(setup, n_stages, interleave):
    """Three steps of 4 microbatches: losses within 1e-5 relative, merged
    parameters within 1e-4 of the JAX LocalPipeline's (optax.adamw)."""
    want_losses, want = _jax_pipeline(setup, n_stages, interleave, 4)
    got_losses, got, pipe = _port_pipeline(setup, n_stages, interleave, 4)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got_losses[-1] < got_losses[0]
    _assert_tree_close(got, want, atol=1e-4)
    if interleave > 1:
        assert pipe.chunk_devices == [torch.device("cpu")] * 4
    assert pipe.last_step_bytes == 0      # every stage on one device


@pytest.mark.parametrize("n_stages,interleave,n_mb",
                         [(2, 1, 4), (4, 1, 8), (2, 2, 4), (2, 2, 8),
                          (3, 2, 8)])
def test_local_pipeline_equals_one_program_step(setup, n_stages, interleave,
                                                n_mb):
    """The same three steps through train/step.py on the whole batch:
    losses within 1e-5 relative, parameters within 1e-4. (3, 2, 8) cuts 4
    layers into 6 chunks, two of them empty, and takes the interleaved
    order's fallback (8 % 3 != 0)."""
    _, tc, _, tree, tokens = setup
    params = _port_params(tree, tc)
    for _, p in optim.leaves(params):
        p.requires_grad_(True)
    opt = optim.adamw(LR)
    state = {"params": params, "opt": opt.init(params)}
    step = make_step(tc, opt)
    batch = torch.from_numpy(tokens).long()
    want_losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        want_losses.append(loss.item())
    got_losses, got, _ = _port_pipeline(setup, n_stages, interleave, n_mb)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _assert_tree_close(got, _port_flat(state["params"]), atol=1e-4)


def test_local_pipeline_refusals(setup):
    _, tc, _, tree, tokens = setup
    params = _port_params(tree, tc)
    with pytest.raises(ValueError, match="2 stages, 1 devices"):
        tp.LocalPipeline(tc, params, 2, optim.adamw(LR), devices=["cpu"])
    pipe = tp.LocalPipeline(tc, params, 2, optim.adamw(LR),
                            devices=["cpu", "cpu"], interleave=2)
    batch = torch.from_numpy(tokens).long()
    with pytest.raises(ValueError, match="needs n_microbatches >= 4"):
        pipe.train_step(batch, n_microbatches=2)
    with pytest.raises(ValueError, match="does not divide"):
        pipe.train_step(batch, n_microbatches=3)
