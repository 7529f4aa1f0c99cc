"""Plain PyTorch reference of the benchmark's configurations: imports nothing
of the program and nothing of JAX."""
