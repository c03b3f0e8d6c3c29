"""ray_tpu_torch stands alone: no jax, no ray_tpu module, no silent CPU.

The port keeps its own copy of everything it needs from the JAX package,
so importing any of its modules must load neither jax nor a `ray_tpu.`
module, and its entry points must refuse to run on the CPU unless the
caller asked for it.
"""

import ast
import os
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
    assert {"ray_tpu_torch.train.optim", "ray_tpu_torch.train.step"} <= \
        set(names)
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
