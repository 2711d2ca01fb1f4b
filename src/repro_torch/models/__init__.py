"""The attention-only LM of the serving path, in PyTorch."""
