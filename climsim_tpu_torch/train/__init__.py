"""Training: losses, learning-rate schedules, train/eval steps, recipes."""
