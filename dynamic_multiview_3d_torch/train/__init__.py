"""Training: losses, metrics and the train step (port of train/)."""
