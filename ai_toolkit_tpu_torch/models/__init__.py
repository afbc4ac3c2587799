"""Models of the port: FLUX DiT, its VAE and text encoders, and the model wrapper."""
