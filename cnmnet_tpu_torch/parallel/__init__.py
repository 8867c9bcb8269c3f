"""Distribution (``cnmnet_tpu/parallel/``): ``mesh`` lays out the ranks and
plans which rows each tile rank holds, ``collectives`` sums and gathers
over a named group, ``sharding`` splits batches and rows and fetches the
rows a rank reads, ``tiled_ops`` runs the kernels on row shards. The
package re-exports nothing, so importing ``collectives`` (the loss ops and
the layers do) loads no other module of it."""
