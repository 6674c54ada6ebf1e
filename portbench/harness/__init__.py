"""What every cell shares: the cell's files, the card, the seeded inputs and
weights, the profiler window and its reduction, the correctness verdict."""
