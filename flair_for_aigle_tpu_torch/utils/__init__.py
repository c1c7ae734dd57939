# Config IO, logging/messaging and config recap of the port (copies of the JAX package's utils/,
# rank-zero gated through the port's own parallel.dist).
