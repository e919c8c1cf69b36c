"""MPWide core, as far as the port has come: paths, chunk planning, the
link model and autotuner, telemetry, retry policy, the continuous batcher and
KV shipping."""
