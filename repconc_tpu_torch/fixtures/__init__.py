"""Committed inputs of checks on real models (see heldout.py)."""
