"""Host utilities: RNG, timings, results, state conversion."""
