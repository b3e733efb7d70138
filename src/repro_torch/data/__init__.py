"""The data pipeline of the port: deterministic synthetic token batches."""
