"""Request tracing, the engine flight recorder and the profiler wrapper of
the port (``tracing``, ``flight``, ``profiling``)."""
