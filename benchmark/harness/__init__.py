"""The benchmark's general machinery: it finds a cell's configuration,
traffic and metrics by name (``spec``), makes the weights (``weights``) and
the requests (``traffic``), runs the window (``main``), reads the profiler's
trace (``trace``) and judges the outputs (``check``)."""
