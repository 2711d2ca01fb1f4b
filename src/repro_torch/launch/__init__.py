"""Command-line entry points: ``serve`` (the paper's queueing experiment in
virtual time), ``sidecar`` (the HTTP/SSE proxy) and ``train`` (the LM's
training loop)."""
