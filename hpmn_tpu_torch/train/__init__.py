"""Training: the optimizer (``optim``), the training step and driver
(``train``), the metrics and evaluation, and checkpoints."""
