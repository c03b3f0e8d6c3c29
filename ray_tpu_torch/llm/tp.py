"""Tensor-parallel serving over a world of ranks: the port's counterpart of
the JAX runner's `mesh=` (ray_tpu/llm/model_runner.py, placement by
SERVE_RULES, the KV pool split on its kv heads, attention on each shard's
heads).

The JAX package runs one controller over a tp mesh. Here the process that
builds the engine is rank 0 of a `parallel.launch.World` of `tp` ranks
(NCCL on cards, gloo on the CPU); ranks 1..tp-1 run `serve_follower`,
which builds the same runner on its card and runs each command rank 0
sends. Scheduling, the block manager and sampling state exist once, on
rank 0; the other ranks hold only their shards, their KV heads and their
CUDA graphs.

    world = start_world(2, "cuda")
    runner = build_runner(spec, world, "cuda")        # on rank 0
    runner.on_close = lambda: stop_world(world)
    ...
    runner.close()                                    # stops the world

Where the weights come from (`spec["source"]`):
  * ("seed", s): every rank draws the same `llama.init_params` from s on
    its own card and keeps its shards;
  * ("checkpoint", dir): every rank reads the manifest-format checkpoint
    leaf by leaf (a train state's "params" subtree, or a parameter tree)
    and keeps its shards;
  * ("broadcast",): rank 0 holds the global tree and sends it leaf by leaf
    over the device group.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.launch import Channel, World
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ray_tpu_torch.parallel.sharding import SERVE_RULES, shard, spec_for

CMD_BUILD, CMD_STOP = 3, 4


def param_paths(config: llama.LlamaConfig) -> List[Tuple[tuple, tuple]]:
    """(keys, global shape) of every parameter, in sorted-key order."""
    d, v, L = config.d_model, config.vocab_size, config.n_layers
    out = [(("embed",), (v, d)), (("final_norm",), (d,))]
    out += [(("layers", k), (L,) + shape) for k, (shape, _) in
            sorted(llama.layer_shapes(config).items())]
    out.append((("lm_head",), (d, v)))
    return out


def _put(tree: Dict, keys: tuple, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _at(tree: Dict, keys: tuple):
    for k in keys:
        tree = tree[k]
    return tree


def _local(x: torch.Tensor, keys: tuple, mesh, device, dtype) -> torch.Tensor:
    """This rank's shard of global parameter `x`, a contiguous copy on
    `device` in `dtype` (the whole of it without a mesh)."""
    if mesh is not None:
        x = shard(x, spec_for(mr.param_axes_at(keys), SERVE_RULES), mesh)
    return x.to(device=device, dtype=dtype, copy=True).contiguous()


def _checkpoint_leaves(directory: str, config: llama.LlamaConfig):
    """(keys, global CPU tensor) of every parameter from a manifest-format
    checkpoint, one leaf at a time: a parameter tree, or the "params"
    subtree of a train state (whose optimizer leaves are never read)."""
    from ray_tpu_torch.checkpoint import CheckpointError, read_manifest
    from ray_tpu_torch.checkpoint.restore import iter_global_leaves

    records = read_manifest(directory)["leaves"]
    prefix = ([{"key": "params"}]
              if any(r["path"][:1] == [{"key": "params"}] for r in records)
              else [])
    want = dict(param_paths(config))
    seen = set()
    for _, rec, leaf in iter_global_leaves(
            directory, select=lambda r: r["path"][:len(prefix)] == prefix):
        keys = tuple(seg.get("key") for seg in rec["path"][len(prefix):])
        if keys not in want or tuple(leaf.shape) != want[keys]:
            raise CheckpointError(
                f"{directory!r}: leaf {keys} {tuple(leaf.shape)} is no "
                f"parameter of this model ({config})")
        seen.add(keys)
        yield keys, leaf
    missing = sorted(set(want) - seen)
    if missing:
        raise CheckpointError(f"{directory!r} lacks parameters {missing}")


def local_params(source: tuple, config: llama.LlamaConfig, mesh, device,
                 params: Optional[Dict] = None) -> Dict:
    """This rank's parameter shards (the whole tree without a mesh) on
    `device` in config.dtype, from `source` (see the module docstring);
    `params` is rank 0's global tree for ("broadcast",)."""
    device = torch.device(device)
    dtype = config.dtype
    out: Dict = {}
    kind = source[0]
    if kind == "seed":
        gen = torch.Generator(device=device).manual_seed(int(source[1]))
        whole = llama.init_params(config, gen, device)
        for keys, _ in param_paths(config):
            _put(out, keys, _local(_at(whole, keys), keys, mesh, device,
                                   dtype))
        del whole
    elif kind == "checkpoint":
        for keys, leaf in _checkpoint_leaves(source[1], config):
            _put(out, keys, _local(leaf, keys, mesh, device, dtype))
    elif kind == "broadcast":
        rank0 = mesh is None or dist.get_rank() == 0
        for keys, shape in param_paths(config):
            if rank0:
                x = _at(params, keys).to(device=device, dtype=dtype)
            else:
                x = torch.empty(shape, dtype=dtype, device=device)
            if mesh is not None:
                dist.broadcast(x, src=0)
            _put(out, keys, _local(x, keys, mesh, device, dtype))
            del x
    else:
        raise ValueError(f"unknown weight source {source!r}")
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    return out


def start_world(tp: int, device) -> World:
    """Rank 0 of a new world of `tp` ranks (the caller), its followers
    running `serve_follower`, and the world's mesh (MeshConfig(tp=tp)) as
    `world.mesh`. Raises when the machine has fewer cards than `tp`."""
    device = torch.device(device)
    world = World(tp, serve_follower, device.type, device=str(device))
    try:
        world.mesh = build_mesh(MeshConfig(tp=tp), device=world.device.type)
    except BaseException:
        world.close()
        raise
    return world


def _lora_manager(spec: Dict, mesh, device):
    if spec.get("lora") is None:
        return None
    from ray_tpu_torch.llm.lora import LoRAManager

    n_slots, rank, targets = spec["lora"]
    tp = (0, 1) if mesh is None else (mesh.get_local_rank("tp"),
                                      mesh.size(mesh.mesh_dim_names.index(
                                          "tp")))
    return LoRAManager(spec["config"], n_slots=n_slots, rank=rank,
                       targets=targets, device=device, tp=tp)


def _runner(spec: Dict, mesh, device, channel, params=None):
    local = local_params(spec["source"], spec["config"], mesh, device,
                         params)
    return mr.ModelRunner(
        spec["config"], local, num_blocks=spec["num_blocks"],
        block_size=spec["block_size"], chunk_size=spec["chunk_size"],
        device=device, cuda_graphs=spec["cuda_graphs"],
        lora_manager=_lora_manager(spec, mesh, device), mesh=mesh,
        channel=channel)


def stop_world(world: World) -> None:
    """Stop the followers of a serving world and leave it."""
    world.close(stop=lambda ch: ch.send(CMD_STOP))


def build_runner(spec: Dict, world: Optional[World], device,
                 params: Optional[Dict] = None) -> "mr.ModelRunner":
    """The runner of rank 0 (of `world`, or alone without one), after the
    other ranks were told to build theirs (a rank's next build, or the
    world's stop, closes its previous runner). `spec`: config, num_blocks,
    block_size, chunk_size, cuda_graphs, lora ((n_slots, rank, targets) or
    None) and source. The world stays the caller's: `runner.on_close` is
    where its owner stops it."""
    if world is None:
        return _runner(spec, None, device, None, params)
    world.channel.send(CMD_BUILD, payload={k: v for k, v in spec.items()})
    return _runner(spec, world.mesh, device, world.channel, params)


def serve_follower(rank: int, size: int, channel: Channel,
                   device: str) -> None:
    """Ranks 1..size-1 of a serving world: build the mesh, then take rank
    0's commands (build a runner, run an entry point or a unified step)
    until told to stop."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    mesh = build_mesh(MeshConfig(tp=size), device=device.type)
    runner = None
    while True:
        kind, args, payload, tensors = channel.recv()
        if kind in (CMD_STOP, CMD_BUILD) and runner is not None:
            runner.close()
            runner = None
        if kind == CMD_STOP:
            return
        if kind == CMD_BUILD:
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            runner = _runner(payload, mesh, device, None)
        elif kind == mr.CMD_MIXED:
            runner.follow_mixed(*args[:6])
        elif kind == mr.CMD_CALL:
            runner.run_call(payload, tensors)
        else:
            raise RuntimeError(f"unknown command {kind}")
