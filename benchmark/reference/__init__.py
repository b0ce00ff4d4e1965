"""The benchmark's plain references: NumPy and plain ``torch`` code that
imports nothing of the program and works every answer out again from the
inputs the benchmark hands both sides."""
