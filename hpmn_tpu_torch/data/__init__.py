"""Data: numpy synthetic generators, the preprocessing of real logs (the
``process_*`` CLIs, the native parser and batcher), the tensor batch schema
and the batch loader."""
