"""Training of both stages (`stage1`, `stage2`): the trainers' losses and
frozen encodes, the training state with fp32 masters (`train_state`),
AdamW as optax computes it (`optim`), the step (`loop`), and data
parallelism over a process group (`distributed`, `sharding`)."""
