"""The plain reference the benchmark holds served tokens against."""
