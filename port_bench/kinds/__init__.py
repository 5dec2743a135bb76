"""Traffic kinds, one module per ``kind`` named in a traffic mix's data
file: each gives its ``Mix`` and its control readings (``harness/mix``)."""
