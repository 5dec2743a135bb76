"""The plain reference: plain PyTorch that reads the same scene files as
the program and imports nothing of it, run once a run's window has closed
to decide ``correct``."""
