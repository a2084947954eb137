"""Copied ops of the reference."""
