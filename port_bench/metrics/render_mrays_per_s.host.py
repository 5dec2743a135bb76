"""render_mrays_per_s.host: as render_mrays_per_s, in the cells whose calls
leave the host a large share of each render (short renders, huge graphs),
so runs spread by several percent and the bound is wider."""

from port_bench.harness.readers import mrays_per_s as read  # noqa: F401
