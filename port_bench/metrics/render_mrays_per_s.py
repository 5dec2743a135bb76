"""render_mrays_per_s: ray segments of every render in the window, as the
upstream renderer counts them (``harness/counts.rays_per_render``), over
the window's seconds (host clock), in millions; in the cells whose renders
keep the device busy, so runs spread little."""

from port_bench.harness.readers import mrays_per_s as read  # noqa: F401
