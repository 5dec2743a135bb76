"""The general parts of the benchmark: finding a cell's files by name, the
closed-loop window, the profiler window and its reading, the comparison
with the reference, and the checks of the card and of the imports."""
