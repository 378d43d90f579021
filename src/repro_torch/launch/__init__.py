"""Launch drivers of the port: `serve` (the LLM wave server, and the
mapping service behind ``--map-trace``)."""
