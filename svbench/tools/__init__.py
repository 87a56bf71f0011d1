"""Tools run by hand: the knee sweep, the readings limits are set from."""
