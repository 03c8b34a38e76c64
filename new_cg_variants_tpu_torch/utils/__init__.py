"""Environment capture and profiling utilities."""
