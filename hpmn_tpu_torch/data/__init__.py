"""Data: numpy synthetic generators, the tensor batch schema and the
batch loader."""
