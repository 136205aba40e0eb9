"""Samples of the PyTorch port (counterparts of the repository's samples/)."""
