"""Reading a profiler trace: the frozen counting rules and the traced
segment's summary that the per-layer readers take their numbers from."""
