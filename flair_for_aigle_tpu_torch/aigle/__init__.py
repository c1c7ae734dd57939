# Aigle orchestration of the port (copies of the JAX package's framework-free aigle/ modules, and
# the run driver on the port's zonal engine): CLI config merge, S3 data plumbing, class mapping,
# PostGIS / GPKG export.
