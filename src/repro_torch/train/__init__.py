"""Training: optimizers, schedules, the train step, checkpoints, the
fault-tolerant loop."""
