"""Models: the hpmn encoder, readout, tower, losses, and the forward and
loss (``models.model``)."""
