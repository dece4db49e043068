"""Flow-matching training (port of train/): the Adam+EMA step, reference-
layout .pth checkpoints, the preemption-safe epoch driver."""
