"""RLHF's in-process pieces: rollouts on the port's engine (`rollout`),
the PPO learner at world 1 (`trainer`) and the colocated weight swap
(`weight_sync`). The actor halves (generator replicas, learner gangs,
object-plane weight broadcast) need a runtime and are not ported."""
