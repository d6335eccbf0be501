"""Models: the hpmn encoder, readout, tower and the forward
(``models.model``)."""
