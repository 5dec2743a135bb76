"""Image IO."""
