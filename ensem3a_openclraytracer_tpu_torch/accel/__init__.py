"""Acceleration structures (Morton ordering; the BVH comes later)."""
