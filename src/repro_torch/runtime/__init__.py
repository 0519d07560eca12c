"""The fault-tolerant training loop (`fault`): the port of `repro.runtime`."""
