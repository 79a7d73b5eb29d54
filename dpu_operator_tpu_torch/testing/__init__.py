"""Deterministic fault injection for the port's serving path."""
