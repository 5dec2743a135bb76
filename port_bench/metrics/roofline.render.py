"""roofline.render: the least time a render's work could take on the card
over the device's busy time per traced render, in percent.

The work is what any exact renderer must do on these inputs, counted by
the reference on the compared pixels and scaled to the image
(``harness/counts.least_seconds``): one ray-triangle test per ray segment
traced, the shading of every live lane and bounce and of every sun ray,
and each input and output byte once.  It does not depend on how the
program finds its hits, so no change of the program can push it past 100."""

from port_bench.harness.readers import roofline as read  # noqa: F401
