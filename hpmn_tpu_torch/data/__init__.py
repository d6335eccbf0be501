"""Data: numpy synthetic generators and the tensor batch schema."""
