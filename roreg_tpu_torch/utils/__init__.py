"""Observability: stage timers and JSONL logs."""
