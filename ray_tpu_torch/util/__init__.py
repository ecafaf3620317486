"""Process-local observability the serve layer records into (copied from
ray_tpu/util): ``metrics`` (Counter, Gauge, Histogram and the Prometheus
text), ``flight_recorder`` (rings of recent events) and ``timeline`` (the
clock offsets request anatomy aligns stamps with). In one process there is
no node to push from or fold in, so the cluster parts of those modules are
not copied."""
