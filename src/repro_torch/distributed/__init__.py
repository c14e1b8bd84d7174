"""Index sharding: the shard cutter of the JAX package's ``distributed/retrieval.py``."""
