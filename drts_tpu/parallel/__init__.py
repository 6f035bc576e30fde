"""Device-mesh sharding of the frame (SURVEY.md §2.4/§5.8).

The reference is single-GPU; its only parallelism is per-pixel SIMT. Here
the first-class parallelism across devices is data-parallel pixel-row
sharding over a jax.sharding.Mesh: scene and camera replicate, every
(H, W, ...) frame buffer shards over image rows, and XLA/GSPMD inserts the
collectives (halo exchanges for spatial filters, gathers at assembly).
"""
