# Training data host modules of the port (copies of the JAX package's framework-free data/):
# numpy transforms, Sentinel time-series handling, padding/collate, CSV paths, datasets, loaders.
