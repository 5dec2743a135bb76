"""Per-ray math and the closest-hit kernel wrapper."""
