"""Rank-side jobs of the port's parallel CPU tests.

Each job runs on every rank of a gloo world started by
`ray_tpu_torch.parallel.launch.spawn`, and imports only the port (never
jax): the test process computes the JAX package's side. Inputs arrive as
numpy arrays; rank 0 returns the gathered results as numpy arrays (the
other ranks return None). `run_jobs` runs a list of jobs in one world and
keeps each job's traceback, so one failing job fails only its tests.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import fsdp
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh, use_mesh
from ray_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from ray_tpu_torch.parallel.sharding import (TRAIN_RULES, gather_tree,
                                             shard_from_numpy, shard_tree,
                                             tree_specs)
from ray_tpu_torch.train.optim import adamw, leaves

BATCH_AXES = {"tokens": ("batch", None)}


def run_jobs(rank, world, jobs):
    """jobs: [(name, job function name, kwargs)] -> {name: (ok, result)}."""
    out = {}
    for name, fn, kwargs in jobs:
        try:
            out[name] = (True, globals()[fn](rank, world, **kwargs))
        except Exception:
            out[name] = (False, traceback.format_exc())
        torch.distributed.barrier()
    return out if rank == 0 else None


def fail_on(rank, world, bad_rank):
    torch.distributed.barrier()
    if rank == bad_rank:
        raise ValueError("planted failure")
    torch.distributed.barrier()   # the other ranks wait here until killed


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def mesh_info(rank, world, mesh):
    from torch.distributed.device_mesh import init_device_mesh

    m = build_mesh(MeshConfig(**mesh), device="cpu")
    info = {a: (m.size(i), m.get_local_rank(a))
            for i, a in enumerate(("dp", "fsdp", "sp", "ep", "tp"))}
    # build_mesh makes its per-axis groups itself (no split_group): the
    # same ranks along every axis as torch's init_device_mesh.
    ref = init_device_mesh("cpu", MeshConfig(**mesh).axis_sizes(),
                           mesh_dim_names=m.mesh_dim_names)
    ranks = torch.distributed.get_process_group_ranks
    info["groups"] = {a: (ranks(m.get_group(a)), ranks(ref.get_group(a)))
                      for a in m.mesh_dim_names}
    info["coordinates"] = (m.get_coordinate(), ref.get_coordinate())
    try:
        build_mesh(MeshConfig(fsdp=world + 1), device="cpu")
        info["wrong_world"] = None
    except ValueError as e:
        info["wrong_world"] = str(e)
    infos = [None] * world
    torch.distributed.all_gather_object(infos, info)
    return infos if rank == 0 else None


def attention(rank, world, impl, q, k, v, cot, causal):
    """Ring or Ulysses over sp = world: output and (dq, dk, dv) of
    sum(out * cot), gathered along the sequence."""
    mesh = build_mesh(MeshConfig(sp=world), device="cpu")

    def local(a):
        return torch.from_numpy(a).chunk(world, dim=1)[rank].clone()

    q, k, v = (local(a).requires_grad_(True) for a in (q, k, v))
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(q, k, v, mesh=mesh, axis="sp", causal=causal)
    grads = torch.autograd.grad((out * local(cot)).sum(), [q, k, v])
    res = [col.gather_global(t.detach(), mesh, 1, "sp")
           for t in (out, *grads)]
    return [t.numpy() for t in res] if rank == 0 else None


def _model(family):
    return {"llama": (llama, llama.LlamaConfig), "moe": (moe, moe.MoEConfig)
            }[family]


def train(rank, world, family, mesh, config, tree, tokens, lr, steps):
    """The first step's loss, grad_norm and gathered gradients (loss_fn
    under the mesh, then fsdp's reductions), and after `steps` steps of
    fsdp.build_train_step each step's metrics and the gathered params."""
    mod, cfg_cls = _model(family)
    config = cfg_cls.tiny(dtype=torch.float32, **config)
    m = build_mesh(MeshConfig(**mesh), device="cpu")
    axes = mod.param_logical_axes(config)
    specs = tree_specs(axes, TRAIN_RULES)
    flat_specs = fsdp.flat_specs(specs)
    batch = {"tokens": torch.from_numpy(tokens)}

    params = shard_from_numpy(tree, axes, TRAIN_RULES, m, device="cpu")
    flat = [p.requires_grad_(True) for _, p in leaves(params)]
    local = shard_tree(batch, BATCH_AXES, TRAIN_RULES, m)
    with use_mesh(m, TRAIN_RULES):
        loss, metrics = mod.loss_fn(params, local, config)
        grads = torch.autograd.grad(loss, flat)
    grads = fsdp.reduce_gradients(grads, flat_specs, m)
    first = {"loss": loss.item(), "total_loss": loss.item(),
             "grad_norm": fsdp.global_norm(grads, flat_specs, m).item(),
             "metrics": {k: v.item() for k, v in metrics.items()}}
    tree_grads = {}
    for (path, _), g in zip(leaves(params), grads):
        node = tree_grads
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = g
    first["grads"] = _np(gather_tree(tree_grads, specs, m))

    init_fn, make_step = fsdp.build_train_step(
        lambda p, b: mod.loss_fn(p, b, config), adamw(lr), m, axes,
        BATCH_AXES, TRAIN_RULES)
    state, state_specs = init_fn(mod.params_from_numpy(tree, config,
                                                       device="cpu"))
    step = make_step(state_specs)
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append({k: v.item() for k, v in metrics.items()})
    final = _np(gather_tree(state["params"], state_specs["params"], m))
    if rank:
        return None
    return {"first": first, "history": history, "params": final,
            "step": state["step"]}


def collectives(rank, world):
    """Each autograd collective and the step's reductions on 4 ranks
    against values computed here from the global tensors: {check: None
    if it holds, else what differed}, from every rank."""
    grid = build_mesh(MeshConfig(fsdp=2, tp=2), device="cpu")
    ring = build_mesh(MeshConfig(sp=world), device="cpu")
    f_idx, t_idx = grid.get_local_rank("fsdp"), grid.get_local_rank("tp")
    f_peers = [r for r in range(world) if r % 2 == t_idx]   # same tp index
    t_peers = [2 * f_idx, 2 * f_idx + 1]                     # same fsdp index
    gen = torch.Generator().manual_seed(5)
    full = torch.randn(4, 6, generator=gen)
    out = {}

    def check(name, got, want):
        ok = torch.allclose(got, want, rtol=1e-6, atol=1e-6)
        out[name] = None if ok else f"rank {rank}: {got} != {want}"

    # all_gather over fsdp; the backward sums the fsdp peers' gradients.
    x = full.chunk(2)[f_idx].clone().requires_grad_(True)
    y = col.all_gather(x, grid, 0, "fsdp")
    (g,) = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    check("all_gather", torch.cat([y.detach(), g]), torch.cat(
        [full, torch.full_like(x, float(sum(r + 1 for r in f_peers)))]))
    # f: identity forward, all-reduce backward; g: the reverse.
    x = full.clone().requires_grad_(True)
    y = col.copy_to(x, grid, "tp")
    (g,) = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    z = col.reduce_from(x * (rank + 1), grid, "tp")
    (h,) = torch.autograd.grad(z.sum(), [x])
    tp_sum = float(sum(r + 1 for r in t_peers))
    check("copy_to_reduce_from", torch.stack([y.detach(), g, z.detach(),
                                              h]),
          torch.stack([full, torch.full_like(full, tp_sum), full * tp_sum,
                       torch.full_like(full, float(rank + 1))]))
    # ring_shift: rank r gets r-1's tensor; the gradient goes back.
    x = torch.full((3,), float(rank)).requires_grad_(True)
    (y,) = col.ring_shift((x,), ring, "sp")
    (g,) = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    check("ring_shift", torch.stack([y.detach(), g]), torch.stack(
        [torch.full((3,), float((rank - 1) % world)),
         torch.full((3,), float((rank + 1) % world + 1))]))
    # all_to_all: chunk j of dim 1 goes to rank j, stacked along dim 0 in
    # rank order; the backward is the inverse all-to-all.
    x = (torch.arange(8.0) + 100 * rank).reshape(1, 8).requires_grad_(True)
    y = col.all_to_all(x, ring, "sp", split_dim=1, concat_dim=0)
    weights = torch.arange(8.0).reshape(4, 2) + 10 * rank
    (g,) = torch.autograd.grad((y * weights).sum(), [x])
    want_y = torch.stack([torch.arange(2.0) + 2 * rank + 100 * r
                          for r in range(world)])
    want_g = torch.cat([torch.arange(2.0) + 2 * rank + 10 * j
                        for j in range(world)])[None]
    check("all_to_all", torch.cat([y.detach().flatten(), g.flatten()]),
          torch.cat([want_y.flatten(), want_g.flatten()]))
    # gather_tree inverts shard_tree for multi-axis specs.
    tree = {"a": torch.randn(8, 6, generator=gen),
            "b": {"c": torch.randn(4, 6, 2, generator=gen)}}
    axes = {"a": ("vocab", "embed"), "b": {"c": ("batch", "mlp", None)}}
    back = gather_tree(shard_tree(tree, axes, TRAIN_RULES, grid),
                       tree_specs(axes, TRAIN_RULES), grid)
    check("gather_tree", torch.cat([back["a"].flatten(),
                                    back["b"]["c"].flatten()]),
          torch.cat([tree["a"].flatten(), tree["b"]["c"].flatten()]))
    # The global norm from shards is the norm of the global tensors; a
    # gradient replicated over a batch axis is summed over it only.
    specs = fsdp.flat_specs(tree_specs(axes, TRAIN_RULES))
    local = shard_tree(tree, axes, TRAIN_RULES, grid)
    norm = fsdp.global_norm([local["a"], local["b"]["c"]], specs, grid)
    check("global_norm", norm, torch.sqrt(tree["a"].square().sum()
                                          + tree["b"]["c"].square().sum()))
    partial = [full * (rank + 1)]
    summed = fsdp.reduce_gradients(partial, [((), ("tp",))], grid)[0]
    check("reduce_gradients", summed,
          full * float(sum(r + 1 for r in f_peers)))
    outs = [None] * world
    torch.distributed.all_gather_object(outs, out)
    return outs if rank == 0 else None


def _llama_step(config, mesh_kw, lr):
    """(mesh, specs, init_fn, make_step) of the tiny fp32 Llama's sharded
    train step on `mesh_kw`."""
    m = build_mesh(MeshConfig(**mesh_kw), device="cpu")
    init_fn, make_step = fsdp.build_train_step(
        lambda p, b: llama.loss_fn(p, b, config), adamw(lr), m,
        llama.param_logical_axes(config), BATCH_AXES, TRAIN_RULES)
    return m, init_fn, make_step


def mesh_checkpoint(rank, world, mesh, config, tree, tokens, lr, steps,
                    directory):
    """`steps` steps on the mesh, save_state into `directory`, then one
    more step: the losses of all steps (the last is the uninterrupted
    run's next loss) and this rank's bytes written."""
    from ray_tpu_torch.parallel.checkpoint import save_state

    config = llama.LlamaConfig.tiny(dtype=torch.float32, **config)
    m, init_fn, make_step = _llama_step(config, mesh, lr)
    state, specs = init_fn(llama.params_from_numpy(tree, config,
                                                   device="cpu"))
    step, batch = make_step(specs), {"tokens": torch.from_numpy(tokens)}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    saved = save_state(state, specs, m, directory)
    state, metrics = step(state, batch)
    losses.append(metrics["loss"].item())
    return {"losses": losses, "saved": saved, "rank": rank}


def mesh_resume(rank, world, mesh, config, tree, tokens, lr, directory):
    """restore_state on this world's mesh, then one step: its loss, the
    restored step count and the params gathered after it."""
    from ray_tpu_torch.parallel.checkpoint import restore_state

    config = llama.LlamaConfig.tiny(dtype=torch.float32, **config)
    m, init_fn, make_step = _llama_step(config, mesh, lr)
    _, specs = init_fn(llama.params_from_numpy(tree, config, device="cpu"))
    state = restore_state(directory, specs, m)
    restored_step = state["step"]
    state, metrics = make_step(specs)(state,
                                      {"tokens": torch.from_numpy(tokens)})
    params = _np(gather_tree(state["params"], specs["params"], m))
    return {"loss": metrics["loss"].item(), "step": restored_step,
            "count": state["opt_state"]["count"],
            "params": params if rank == 0 else None}
