# Process-rank helpers on torch.distributed (port of flair_for_aigle_tpu.parallel.dist).
