"""Command-line entry point of the port."""
