"""Step functions (train, prefill, greedy decode) and checkpoints."""
