"""General drivers, one per kind of traffic file: ``serve``, ``train``."""
