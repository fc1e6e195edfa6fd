"""The harness's generic parts: finding a cell's files by name, the card,
the profiler trace and its counting rules, and the roofline
arithmetic.  Nothing here names a cell, a configuration or a metric."""
