"""render_p95_ms: the 95th percentile of every render's latency in the
window, from the call to the image on the host (host clock); in the cells
whose renders keep the device busy."""

from port_bench.harness.readers import p95_ms as read  # noqa: F401
