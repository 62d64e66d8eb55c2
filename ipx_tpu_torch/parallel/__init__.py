"""Scale-out of the port: the batched scenario solve (batch.py) and its
shared-basis polish (batch2.py)."""
