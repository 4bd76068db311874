"""File I/O: the GeoTIFF codec, VRT mosaics and Zarr v2 stores (copies of
the JAX package's ``io/geotiff.py``, ``io/vrt.py`` and ``io/zarr.py``),
the plain-grid raster formats, and the vector files
(``io/vectorfile.py``: GeoJSON, GeoPackage, CSV; ``io/shapefile.py``)."""
