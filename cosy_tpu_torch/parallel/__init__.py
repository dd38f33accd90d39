"""Scale-out over ``torch.distributed``: the (dp, seq, model) mesh, batch
sharding, and tensor, sequence and pipeline parallelism (the port of the
JAX package's ``parallel/``).  One process per device; the collectives
are explicit where GSPMD inserts them in the JAX package."""
