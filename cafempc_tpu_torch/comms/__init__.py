"""LCM wire types and transports of the serving path (port of
`cafempc_tpu/comms/`)."""
