"""Checkpointing of state trees (`ckpt`): the port of `repro.checkpoint`."""
