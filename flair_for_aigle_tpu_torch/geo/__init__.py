# Geospatial host modules of the port (copies of the JAX package's framework-free geo/): affine
# windows, native GeoTIFF / JP2 IO (native/libflairgeo.so via ctypes), GEOS geometry, GeoPackage IO,
# CRS transforms (libproj via ctypes), shapefiles, raster polygonization.
