"""Device selection, precision policy, NaN guards, FLOP counts and
observability (profiler traces, step timers, JSONL metrics)."""
