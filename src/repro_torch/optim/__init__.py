"""The optimizer (`adamw`) and gradient compression (`compression`): the port
of `repro.optim`."""
