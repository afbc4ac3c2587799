"""Adapters on the port's layers (LoRA)."""
