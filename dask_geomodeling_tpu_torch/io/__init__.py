"""File I/O: the GeoTIFF codec and VRT mosaics (copies of the JAX
package's ``io/geotiff.py`` and ``io/vrt.py``), and the vector files
(``io/vectorfile.py``: GeoJSON, GeoPackage, CSV; ``io/shapefile.py``)."""
