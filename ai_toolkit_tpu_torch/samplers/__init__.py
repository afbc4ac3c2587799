"""Samplers of the port (flow matching)."""
