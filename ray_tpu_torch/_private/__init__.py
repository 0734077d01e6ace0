"""The port's internals: the thread-mode runtime (``worker``, the
scheduler, the object and control planes) and measurement helpers
(``perf``, ``benchmarks``)."""
