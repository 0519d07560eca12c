"""The synthetic token stream (`pipeline`): the port of `repro.data`."""
