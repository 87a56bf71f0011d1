"""The benchmark's own tests (CPU, and ``cuda``-marked on the card)."""
