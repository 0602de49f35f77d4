"""Step functions; the serving half (prefill, greedy decode) so far."""
