"""Training: the AdamW optimizer and the Llama train step on one device,
checkpoints, and the data-parallel gradient sync over a collective group
(`backend.reduce_gradients`)."""
