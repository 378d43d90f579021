"""Launch drivers of the port: `serve` (the LLM wave server)."""
