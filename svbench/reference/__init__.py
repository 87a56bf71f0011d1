"""Plain PyTorch reference of the benchmarked models."""
