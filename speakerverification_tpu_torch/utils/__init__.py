"""Tools: system report, model summary and FLOPs, plots."""
