"""Training of the acoustic model: losses, optimizer, the training step."""
