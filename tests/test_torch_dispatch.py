"""Which attention the port runs where its kernels lack the shape.

`ops.attention.attention(impl="auto")` (`auto_impl`) and the serving
runner (`model_runner.uses_kernel`) read the JAX package's "on a TPU" as
"on a CUDA device". Where the JAX rule runs its reference (a head dim that
is not a multiple of 128, such as 80 or 96), the port runs the plain
PyTorch version, on the card too. Where it runs a Pallas kernel that the
port lacks (flash and K5/K6 at head dim 256, K5/K6 at H/K > 32), the port
raises and names the ROADMAP item that adds the kernel; it never runs the
plain version on the card in a kernel's place. These rules are plain
functions of (device type, shape), so the CPU can ask them about "cuda";
the card test runs a head-dim-96 engine on the card.
"""

import contextlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as ta
from ray_tpu_torch.ops import paged_attention as pa


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq", [128, 256])
def test_auto_picks_flash_where_jax_does_and_the_kernels_take_d(
        cpu_jax, monkeypatch, d, sq):
    """The JAX package's `attention(impl="auto")`, asked with
    is_tpu_backend() True ("cuda") and False ("cpu"), against the port's
    `auto_impl`: the same choice wherever the flash kernels take the head
    dim; where the JAX rule picks its Pallas kernel at a head dim the port
    has no kernel for (d = 256), a ValueError naming ROADMAP queue 2 D."""
    import jax.numpy as jnp

    import ray_tpu.ops as jops
    from ray_tpu.ops import attention as ja

    picked = []
    monkeypatch.setattr(ja, "flash_attention",
                        lambda *a, **k: picked.append("flash"))
    monkeypatch.setattr(ja, "mha_reference",
                        lambda *a, **k: picked.append("reference"))
    x = jnp.zeros((1, sq, 2, d), jnp.float32)
    for device, on_tpu in (("cuda", True), ("cpu", False)):
        monkeypatch.setattr(jops, "is_tpu_backend", lambda t=on_tpu: t)
        ja.attention(x, x, x)
        jax_pick = picked.pop()
        if jax_pick == "flash" and d not in ta.FLASH_HEAD_DIMS:
            with pytest.raises(ValueError, match="queue 2 D"):
                ta.auto_impl(device, d, sq)
        else:
            assert ta.auto_impl(device, d, sq) == jax_pick


def test_auto_at_d256_runs_the_reference_on_the_cpu_only():
    """attention(impl="auto") on a d = 256 CPU tensor runs mha_reference;
    on the card `auto_impl` refuses the same shape rather than run the
    plain version in a flash kernel's place."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((1, 300, 2, 256), (1, 300, 1, 256),
                         (1, 300, 1, 256)))
    assert ta.auto_impl("cpu", 256, 300) == "reference"
    assert torch.equal(ta.attention(q, k, v),
                       ta.mha_reference(q, k, v, causal=True))
    with pytest.raises(ValueError, match="head_dim 256.*queue 2 D"):
        ta.auto_impl("cuda", 256, 300)


def test_explicit_flash_at_d256_still_raises(monkeypatch):
    """impl="flash" at a head dim the kernels lack raises on the CUDA
    route (faked: the device check says "cuda"), before any launch."""
    monkeypatch.setattr(ta, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    q = torch.zeros(1, 256, 2, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 256, 1, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 256"):
        ta.attention(q, k, k, impl="flash")


# ---------------------------------------------------------------- the runner


@pytest.mark.parametrize("head_dim,want", [(64, True), (80, False),
                                           (96, False), (128, True),
                                           (256, ValueError)])
def test_runner_kernel_rule(cpu_jax, head_dim, want):
    """On a CUDA device the runner launches K5/K6 at head dims 64 and 128,
    calls their plain versions where the JAX runner runs its reference
    (head dim not a multiple of 128), and raises where the JAX runner runs
    its Pallas kernel and K5/K6 lack the shape (head dim 256, or H/K = 40
    at a multiple of 128). On the CPU it always calls the plain versions.
    The JAX runner's own choice is read from its `attention_impl`."""
    import jax.numpy as jnp

    import ray_tpu.ops as jops
    from ray_tpu.llm import model_runner as jmr
    from ray_tpu.models import llama as jl

    def jax_impl(hd):
        # The JAX runner's "auto" on a TPU; params are not needed for it.
        config = jl.LlamaConfig.tiny(dtype=jnp.float32, d_model=2 * hd,
                                     n_heads=2, n_kv_heads=1, max_seq=16)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jops, "is_tpu_backend", lambda: True)
            m.setattr(jmr.ModelRunner, "_place_params", lambda self, p: p)
            return jmr.ModelRunner(config, None, num_blocks=2,
                                   block_size=8).attention_impl

    assert jax_impl(head_dim) == ("pallas" if head_dim % 128 == 0
                                  else "reference")
    assert tmr.uses_kernel("cpu", head_dim, 32, 8) is False
    if want is ValueError:
        with pytest.raises(ValueError, match="queue 2 D"):
            tmr.uses_kernel("cuda", head_dim, 32, 8)
    else:
        assert tmr.uses_kernel("cuda", head_dim, 32, 8) is want
    # H/K = 40 > 32: K5/K6 lack it at every head dim.
    if head_dim % 128 == 0:
        with pytest.raises(ValueError, match="H=40, K=1"):
            tmr.uses_kernel("cuda", head_dim, 40, 1)
    else:
        assert tmr.uses_kernel("cuda", head_dim, 40, 1) is False


PROMPTS = [[(7 * i + 3) % 128 for i in range(21)], [1, 5, 9, 2, 11, 3, 8]]


def test_head_dim_80_runner_matches_jax_engine(cpu_jax, monkeypatch):
    """A head-dim-80 fp32 config (d_model 160, 2/1 heads): the port's
    unified and split engines give the JAX engine's greedy tokens, and the
    runner calls the plain versions directly, never the kernel wrappers."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm.engine import LLMEngine as JaxEngine
    from ray_tpu.llm.model_runner import ModelRunner as JaxRunner
    from ray_tpu.llm.sampling import SamplingParams as JaxParams
    from ray_tpu.models import llama as jl

    shape = dict(vocab_size=128, max_seq=64, d_model=160, n_heads=2,
                 n_kv_heads=1)
    jconfig = jl.LlamaConfig.tiny(dtype=jnp.float32, **shape)
    jparams = jl.init_params(jconfig, jax.random.key(0))
    jrunner = JaxRunner(jconfig, jparams, num_blocks=32, block_size=8,
                        chunk_size=8)
    assert jrunner.attention_impl == "reference"
    ref = [o.output_token_ids for o in JaxEngine(
        jrunner, max_batch_size=4, prefill_chunk=8).generate(
            PROMPTS, JaxParams(max_tokens=5))]
    tconfig = tl.LlamaConfig.tiny(dtype=torch.float32, **shape)
    assert tconfig.head_dim == 80
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   tconfig, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran at head dim 80")

    for name in ("ragged_paged_attention", "ragged_paged_attention_unified"):
        monkeypatch.setattr(pa, name, refuse)
    for unified in (True, False):
        runner = tmr.ModelRunner(tconfig, tparams, num_blocks=32,
                                 block_size=8, chunk_size=8, device="cpu")
        eng = LLMEngine(runner, max_batch_size=4, prefill_chunk=8,
                        unified_ticks=unified)
        got = eng.generate(PROMPTS, SamplingParams(max_tokens=5))
        assert [o.output_token_ids for o in got] == ref
