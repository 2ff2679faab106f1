"""The benchmark's own code: the yardstick (scenes, plain reference,
comparison, profiler reduction) and the run's plumbing. Nothing here
imports the port at module level; the drivers reach it through
``core.port``."""
