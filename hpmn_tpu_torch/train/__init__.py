"""Training: the optimizer and the training step (``train.train``)."""
