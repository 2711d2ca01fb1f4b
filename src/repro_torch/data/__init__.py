"""Synthetic corpus and tokenizer (copies of the JAX package's)."""
