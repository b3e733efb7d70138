"""The train step of the port: gradients, accumulation and the AdamW update."""
