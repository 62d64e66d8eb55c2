"""Scale-out of the port: the batched scenario solve (batch.py)."""
