"""In-program parallelism over torch.distributed (port of ray_tpu/parallel).

One SPMD program per rank: `mesh` names the five axes, `sharding` maps
logical array axes onto them through a rule table, `collectives` holds the
autograd-aware collectives that GSPMD inserts for the JAX package, `ring`
the sequence-parallel attentions, `fsdp` the sharded train step,
`checkpoint` puts a mesh's train state through the checkpoint format,
`launch` starts ranks on one host (a `World` keeps them behind rank 0),
and `pipeline` runs layer stages on the cards of one process
(`LocalPipeline`); the JAX package's actor pipeline is not ported.
"""
