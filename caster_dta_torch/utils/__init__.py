"""Instrumentation: traces, throughput and step timers (profiling.py) and the
op-boundary byte count of a run (traffic.py)."""
