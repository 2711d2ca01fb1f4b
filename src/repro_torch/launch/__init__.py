"""Command-line entry points: ``serve`` (the paper's queueing experiment in
virtual time) and ``sidecar`` (the HTTP/SSE proxy)."""
