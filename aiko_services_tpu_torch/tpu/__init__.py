"""The port's device tooling: ``profiling.Profiler`` /
``profiling.profile_trace`` (torch.profiler traces with per-element
spans) and ``health.probe_devices`` / ``health.default_prober``."""
from .profiling import Profiler, profile_trace
