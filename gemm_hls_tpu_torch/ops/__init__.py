"""Operators: the semiring registry, kernel wrappers and the matmul front door."""
