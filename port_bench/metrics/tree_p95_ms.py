"""tree_p95_ms: the 95th percentile of every render's latency in the window
(host clock) in the tree cell, where a render takes about 201 ms or about
232 ms, a run at a time or a render at a time: the tail flips between the
two and cannot hold a bound."""

from port_bench.harness.readers import p95_ms as read  # noqa: F401
