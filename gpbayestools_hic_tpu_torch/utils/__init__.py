"""IO contracts, convergence metrics, synthetic problems, the f64 oracle."""
