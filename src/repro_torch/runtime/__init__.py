"""The training runtime of the port: checkpoints and the elastic policy."""
