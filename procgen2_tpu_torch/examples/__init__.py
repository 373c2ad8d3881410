"""Example game modules of the port's batched game protocol."""
