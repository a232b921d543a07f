"""Plain reference of what the timed path produces (imports nothing of the
port and nothing of JAX)."""
