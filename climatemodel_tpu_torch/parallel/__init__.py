"""Multi-shard parallelism on one controller: meshes of devices, their
collectives, the sharded halo-exchange shallow-water steps and the
level-sharded flux scan."""
