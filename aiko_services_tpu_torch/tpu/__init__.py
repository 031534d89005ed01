"""Device health of the port: ``health.probe_devices`` and
``health.default_prober`` (the JAX package's ``tpu.profiling`` is not
ported)."""
