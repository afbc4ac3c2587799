"""Training: losses, optimizers, state and the train step."""
