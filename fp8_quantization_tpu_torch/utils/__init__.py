"""Utilities of the entry points."""
