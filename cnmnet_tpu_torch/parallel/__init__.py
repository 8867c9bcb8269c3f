"""Distribution (``cnmnet_tpu/parallel/``): ``mesh`` lays out the ranks,
``collectives`` sums over the data group, ``sharding`` splits batches and
rows and exchanges halos, ``tiled_ops`` runs the kernels on row shards.
The package re-exports nothing, so importing ``collectives`` (the loss ops
and the layers do) loads no other module of it."""
