"""Evaluation entry points of the port (answer generation)."""
