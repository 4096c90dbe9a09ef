"""What every cell of the benchmark shares."""
