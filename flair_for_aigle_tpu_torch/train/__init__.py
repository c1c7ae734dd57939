# Training path of the PyTorch port: losses, metrics, optimizers/schedules,
# step functions, trainer loop, stages (port of flair_for_aigle_tpu.train).
