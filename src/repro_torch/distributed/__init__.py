"""Device placement of the serving tier (the paged pool's shards,
:mod:`repro_torch.distributed.sharding`), checkpoints
(:mod:`~repro_torch.distributed.checkpoint`) and the fault-tolerance
control plane (:mod:`~repro_torch.distributed.fault_tolerance`)."""
