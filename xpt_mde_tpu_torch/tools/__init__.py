"""Command-line tools that measure the port on a CUDA card."""
