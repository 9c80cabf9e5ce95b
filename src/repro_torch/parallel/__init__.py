"""Meshes of partitions for the port: ``shard_map``, its collectives and the
ambient mesh (:mod:`repro_torch.parallel.compat`)."""
