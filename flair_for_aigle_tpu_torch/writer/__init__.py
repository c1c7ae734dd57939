# Prediction writer of the PyTorch port (metrics come from flair_for_aigle_tpu.writer).
