# Prediction writer and evaluation metrics of the PyTorch port.
