"""Distribution on `torch.distributed`: collectives keyed by mesh dim
name (`comm`), the sharded packed-VP ops and whole-model placement
(`shard_ops`), and the wideband equalizer's subcarrier mesh
(`sharding`)."""
