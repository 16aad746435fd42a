"""Plain reference of the erasure code the benchmark checks the port
against: NumPy and hashlib only, nothing of the port."""
