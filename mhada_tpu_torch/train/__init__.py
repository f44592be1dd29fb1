"""Image training: the step, its losses, checkpoints and CLIs."""
