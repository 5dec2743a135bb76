"""idle_share.render.host: the device's idle share of the traced renders, in
percent: their span (the first call's start to the last call's end) less
the union of the device's kernel, copy and memset spans, over the span."""

from port_bench.harness.readers import idle_share as read  # noqa: F401
