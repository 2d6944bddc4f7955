"""Runtime of the port: crash-safe checkpointing."""
