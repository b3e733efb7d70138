"""The port's ``repro.blocks``: so far the fault types the serving engine isolates."""
