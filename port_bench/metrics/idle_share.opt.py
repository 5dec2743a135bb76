"""idle_share.opt: the device's idle share of the traced steps, in percent:
their span less the union of the device's kernel, copy and memset spans,
over the span."""

from port_bench.harness.readers import idle_share as read  # noqa: F401
