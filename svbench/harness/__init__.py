"""The benchmark's general parts: finding a cell's files by name, the
run's clock and result line, seeded inputs, the trace reduction, the
roofline and FLOP counts, and the comparison that decides ``correct``."""
