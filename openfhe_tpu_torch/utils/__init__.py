"""Host-side helpers of the port (exact Python ints and numpy; no torch)."""
