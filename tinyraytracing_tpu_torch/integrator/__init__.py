"""Path-tracing integrators (the queue-fed fused wavefront)."""
