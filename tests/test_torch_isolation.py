"""ray_tpu_torch stands alone: no jax, no ray_tpu module, no silent CPU.

The port keeps its own copy of everything it needs from the JAX package,
so importing any of its modules must load neither jax nor a `ray_tpu.`
module, and its entry points must refuse to run on the CPU unless the
caller asked for it.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_importing_every_module_loads_no_jax_or_ray_tpu():
    names = [name for name, _ in _modules()]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ray_tpu' "
        "or m.startswith('ray_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_neither_jax_nor_ray_tpu():
    offenders = []
    for name, path in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                if root in ("jax", "jaxlib", "ray_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}:"
                                     f"{node.lineno} imports {mod}")
    assert not offenders, offenders


def test_runtime_processes_start_without_torch_jax_or_ray_tpu():
    """The GCS, raylet and worker entry modules (and the package __init__
    they pass through) import neither torch nor jax nor a ray_tpu module:
    a runtime process pays for torch only when a task or actor needs it."""
    code = (
        "import importlib, sys\n"
        "for n in ('ray_tpu_torch.runtime.gcs.main',\n"
        "          'ray_tpu_torch.runtime.raylet.main',\n"
        "          'ray_tpu_torch.runtime.worker_main'):\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_serve_modules_import_neither_torch_jax_nor_ray_tpu():
    """Every module of ray_tpu_torch.serve (and the llm package's lazy
    exports) loads no torch: the controller and proxy actors start without
    it, as the runtime's processes do."""
    names = ["ray_tpu_torch.llm"] + [
        name for name, _ in _modules()
        if name.startswith("ray_tpu_torch.serve")]
    assert {"ray_tpu_torch.serve", "ray_tpu_torch.serve.api",
            "ray_tpu_torch.serve.batching",
            "ray_tpu_torch.serve.config_watcher",
            "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.deployment", "ray_tpu_torch.serve.handle",
            "ray_tpu_torch.serve.http_adapters",
            "ray_tpu_torch.serve.local_testing",
            "ray_tpu_torch.serve.multiplex",
            "ray_tpu_torch.serve.proxy"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_observability_modules_import_neither_torch_jax_nor_ray_tpu():
    """The cluster event bus, the metrics registry and its definitions,
    the state API and the OpenAI router load no torch: the GCS, the
    controller and every runtime process may import them."""
    names = ["ray_tpu_torch.runtime.events", "ray_tpu_torch.util.metrics",
             "ray_tpu_torch.runtime.metric_defs", "ray_tpu_torch.state",
             "ray_tpu_torch.state.api", "ray_tpu_torch.llm.openai_router",
             "ray_tpu_torch.runtime.gcs.server"]
    assert set(names) <= {name for name, _ in _modules()}
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_collective_modules_import_neither_torch_jax_nor_ray_tpu():
    """The collective API, its tcp backend, the object broadcast and the
    multi-node test cluster load no torch: a CPU worker's tcp group and a
    replicated save's broadcast never pay for `import torch` (the torch
    backend imports it when a group asks for it)."""
    names = ["ray_tpu_torch.collective", "ray_tpu_torch.collective.collective",
             "ray_tpu_torch.collective.communicator",
             "ray_tpu_torch.collective.cpu_group",
             "ray_tpu_torch.util.broadcast", "ray_tpu_torch.cluster_utils"]
    assert set(names) <= {name for name, _ in _modules()}
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_runtime_sources_name_no_jax_runtime_variable_or_path():
    """The port's runtime names its own environment variables
    (RAY_TPU_TORCH_*) and its own base directory, so it never reads or
    writes the JAX runtime's token, config, address, store directory or
    session files in a shared process or host."""
    sources = [PKG / "config.py", PKG / "__init__.py"] + sorted(
        p for d in ("core", "runtime", "utils", "util", "state")
        for p in (PKG / d).rglob("*.py"))
    pattern = re.compile(r"RAY_TPU_(?!TORCH_)|/tmp/ray_tpu/")
    offenders = []
    for path in sources:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                offenders.append(f"{path.relative_to(ROOT)}:{i}: {line}")
    assert not offenders, offenders
    assert (PKG / "runtime" / "rpc.py").exists()


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama

    cfg = LLMConfig(model_config=llama.LlamaConfig.tiny(
        dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg.model_config, torch.Generator())
    engine = build_engine(LLMConfig(model_config=cfg.model_config,
                                    device="cpu"))
    assert engine.runner.device.type == "cpu"


def test_train_modules_are_covered_and_refuse_a_missing_card():
    names = [name for name, _ in _modules()]
    assert {"ray_tpu_torch.train.optim", "ray_tpu_torch.train.step",
            "ray_tpu_torch.llm.lora", "ray_tpu_torch.llm.prefix_store",
            "ray_tpu_torch.llm.disagg", "ray_tpu_torch.llm.router",
            "ray_tpu_torch.llm.openai_router", "ray_tpu_torch.state.api",
            "ray_tpu_torch.runtime.events", "ray_tpu_torch.util.metrics",
            "ray_tpu_torch.runtime.metric_defs",
            "ray_tpu_torch.llm.replica_policy",
            "ray_tpu_torch.collective.cpu_group",
            "ray_tpu_torch.runtime.wire", "ray_tpu_torch.runtime.chaos",
            "ray_tpu_torch.runtime.rpc", "ray_tpu_torch.runtime.node",
            "ray_tpu_torch.runtime.gcs.server",
            "ray_tpu_torch.runtime.raylet.raylet",
            "ray_tpu_torch.runtime.worker_main", "ray_tpu_torch.core.api",
            "ray_tpu_torch.core.worker", "ray_tpu_torch.config",
            "ray_tpu_torch.util.tracing", "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch.rl.ppo", "ray_tpu_torch.rlhf.weight_sync",
            "ray_tpu_torch.rlhf.rollout", "ray_tpu_torch.rlhf.trainer",
            "ray_tpu_torch.models.resnet"} <= set(names)
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state

    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(config, adamw(1e-4), torch.Generator())
    state = init_state(config, adamw(1e-4), torch.Generator(), device="cpu")
    assert state["params"]["embed"].device.type == "cpu"


def test_pipeline_learner_and_resnet_refuse_a_missing_card():
    """LocalPipeline's default devices (cuda:0..n-1), LearnerWorker and
    resnet.init raise without a card and run when asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    from ray_tpu_torch.models import llama, resnet
    from ray_tpu_torch.parallel.pipeline import LocalPipeline
    from ray_tpu_torch.rlhf.trainer import LearnerWorker
    from ray_tpu_torch.train.optim import adamw

    config = llama.LlamaConfig.tiny(dtype=torch.float32, n_layers=2)
    params = llama.init_params(config, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalPipeline(config, params, 2, adamw(1e-3))
    pipe = LocalPipeline(config, params, 2, adamw(1e-3),
                         devices=["cpu", "cpu"])
    assert pipe.devices == [torch.device("cpu")] * 2
    tiny = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                n_kv_heads=2, d_ff=64)
    hyper = dict(lr=1e-3, prefix=[], pad_batch=1, pad_tokens=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LearnerWorker(0, 1, tiny, hyper, seed=0)
    learner = LearnerWorker(0, 1, tiny, hyper, seed=0, device="cpu")
    assert learner.policy["lm"]["embed"].device.type == "cpu"
    rconfig = resnet.ResNetConfig(depth="resnet18", width=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.init(rconfig, torch.Generator())
    params, _ = resnet.init(rconfig, torch.Generator(), device="cpu")
    assert params["head"]["w"].device.type == "cpu"
