"""Model configuration and the Mamba-2 model on torch tensors."""
