"""Tools of the PyTorch port that drive its entry points end to end."""
