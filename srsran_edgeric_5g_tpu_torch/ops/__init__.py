"""PHY signal-processing ops on torch tensors."""
