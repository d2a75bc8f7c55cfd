"""Multi-GPU training and serving over torch.distributed: the device mesh
(`mesh`), parameter placement (`sharding`) and tensor parallelism
(`tensor`)."""
