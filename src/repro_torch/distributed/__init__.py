"""Device placement over a mesh of named axes: the logical-axis rules and
the paged pool's shards (:mod:`repro_torch.distributed.sharding`), a
leaf held as its shards (:mod:`~repro_torch.distributed.placement`), the
decode step over a mesh (:mod:`~repro_torch.distributed.sharded_decode`),
checkpoints (:mod:`~repro_torch.distributed.checkpoint`) and the
fault-tolerance control plane (:mod:`~repro_torch.distributed.
fault_tolerance`)."""
