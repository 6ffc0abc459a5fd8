"""The scene and the start states the benchmark makes from its seed."""
