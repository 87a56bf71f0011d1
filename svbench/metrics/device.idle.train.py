"""Share of the traced training window with no device operation running."""

from svbench.harness.readers import idle_share


def read(r):
    return idle_share(r)
