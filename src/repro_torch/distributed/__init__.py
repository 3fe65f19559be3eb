"""Device placement of the serving tier: the paged pool's shards
(:mod:`repro_torch.distributed.sharding`)."""
