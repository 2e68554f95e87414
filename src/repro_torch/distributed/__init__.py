"""Sharding rules of the port (:mod:`repro_torch.distributed.sharding`)."""
