"""roofline.opt: the least time an inverse-rendering step's work could
take on the card over the device's busy time per traced step, in percent.

The work is what any exact step must do (``harness/step_work``), counted
by the reference on the program's lanes (``kinds/optimize_blocks``): the
forward's ray-triangle tests and shading, 28 bytes for every value that
Adam must keep moving once its gradient has reached it, and the other
inputs and outputs once (``harness/counts.least_seconds``).  It leaves
the backward and any pass over values no lane reached out, so no change
of the program can push it past 100."""

from port_bench.harness.readers import roofline as read  # noqa: F401
