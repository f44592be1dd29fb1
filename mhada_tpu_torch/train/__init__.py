"""Image and video training: the steps, their losses, checkpoints and
CLIs."""
