"""Renderers: the scan path-tracing estimator."""
