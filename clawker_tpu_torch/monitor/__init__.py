"""Crash-tolerant JSONL readers (copied from the reference package)."""
