"""Synthetic corpus and tokenizer, the LM token stream and the Table 3
splits (copies of the JAX package's)."""
