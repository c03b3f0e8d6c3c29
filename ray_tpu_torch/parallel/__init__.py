"""In-program parallelism over torch.distributed (port of ray_tpu/parallel).

One SPMD program per rank: `mesh` names the five axes, `sharding` maps
logical array axes onto them through a rule table, `collectives` holds the
autograd-aware collectives that GSPMD inserts for the JAX package, `ring`
the sequence-parallel attentions, `fsdp` the sharded train step,
`checkpoint` puts a mesh's train state through the checkpoint format, and
`launch` starts ranks on one host (a `World` keeps them behind rank 0).
Pipeline parallelism is actor-level in the JAX package and is not ported
here.
"""
