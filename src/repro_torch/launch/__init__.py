"""Launch drivers of the port: `serve` (the LLM wave server, and the
mapping service behind ``--map-trace``), `train` and `dryrun` (every
cell's step traced on the meta device), with `mesh`, `sharding` and
`op_analysis` beneath them."""
