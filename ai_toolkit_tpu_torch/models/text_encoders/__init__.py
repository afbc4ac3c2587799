"""Text encoders of the port (CLIP, T5)."""
