"""Runnable recipes of the port (counterparts of recipes/ at the repo root)."""
