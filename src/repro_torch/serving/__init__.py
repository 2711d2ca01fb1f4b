"""Serving path: fused decoder, serial engine, front end."""
