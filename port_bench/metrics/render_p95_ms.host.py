"""render_p95_ms.host: as render_p95_ms, in the cells whose calls leave the
host a large share of each render, so the bound is wider."""

from port_bench.harness.readers import p95_ms as read  # noqa: F401
