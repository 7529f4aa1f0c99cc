"""HTTP serving (the micro-batching InferenceServer)."""
