"""Multi-GPU training and serving over torch.distributed: the device mesh
(`mesh`), parameter placement (`sharding`), tensor parallelism (`tensor`)
and the pipeline (`pipeline`)."""
