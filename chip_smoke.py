#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dask_geomodeling_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: csrc/gaussian_blur.cu and csrc/moving_max.cu with nvcc for
   sm_90a, and the host C++ (the port's native/tiffcodec.cpp,
   native/jpegcodec.cpp, native/webpcodec.cpp and native/rasterize.cpp,
   and this script's
   chip_smoke_encoders.cpp) with
   g++, from this checkout, all at once; then the elevation sheet of
   the file paths (write_sheet: one AHN sheet, 10000 x 12500 float32 at
   0.5 m in EPSG:28992, written with the port's GeoTIFF writer into a
   temporary folder);
3. kernel checks, on the card against the plain torch versions
   (torch.equal): the Gaussian at the headline path's shape (64, 516, 516)
   and sigma (radius 3), at the stencils path's (64, 524, 524) and sigma
   5/3 (radius 7), at the file-read path's (64, 524, 524) and sigma 2
   (radius 8), at radius 8 and at a zoom-mode radius 40, and one plane
   against scipy.ndimage.gaussian_filter, bitwise; the integer frames'
   entry (float64 storage truncated toward zero between the passes) on
   every integer width from int8 to uint64 and on a uint8 (64, 524, 524)
   batch; the moving maximum at
   the stencils path's shape (64, 526, 526) float32 size 3, also against
   torch's max_pool2d, at sizes 5, 7 and 15, at sizes 3, 5 and 7 in every
   integer and float width, and with NaN in a plane; each kernel's static
   SASS opcode counts (cuobjdump) are printed after its build;
4. headline path: the view of bench.py (8192^2 EPSG:28992 source) over a
   10240^2 EPSG:3857 request in 512^2 tiles, batches of 64 (of tiles
   whose Smooth sigma agrees), through the port's evaluate_tiled and
   get_data.  The Gaussian launches once per batch (fused), no node runs
   on the host, a view with a node that has
   no twin raises, a 64^2 corner equals compute_host bit for bit, and 16
   tiles spread over the request differ from it in at most 5e-4 of their
   cells;
4b. border-reproject: the headline's chain over a 2048^2
   float32 source of 4 m cells (the 8192 m square of an 8192^2 source of
   1 m, cut to a sixteenth of its cells for the JSON leg's time) in
   EPSG:25832 (ETRS89 / UTM 32N) over Gronau, sent
   through to_json and Block.from_json as a service registers a layer
   (the token kept; its data comes back float64), asked for its
   footprint in EPSG:28992 at 10240^2: two datums and two projection
   families, with the checks of 6 and the headline's 5e-4 share; then
   crs-families: the same chain over a 1024^2 source in each CRS of
   CRS_FAMILIES requested in EPSG:3857, and over RD New with a synthetic
   NTv2 grid for the Amersfoort datum (write_amersfoort_grid), tile by
   tile within 5e-4 of compute_host; cumulative-nesting: a
   TemporalAggregate and a Cumulative over a Cumulative of an
   elementwise node at 1024^2, bitwise; json-integer: a uint8 source + 1
   loaded from JSON answers int64 on the card, as on the host;
5. stencils path: HillShade(Smooth(MovingMax(source, 3), 5)) of
   benchmarks/run.py over its 8192^2 float32 EPSG:28992 source, requested
   whole in the same CRS: 256 tiles in 4 batches.  One moving-max and one
   fused Gaussian launch per batch, no node on the host, a 64^2 corner of
   the view below HillShade bitwise equal to compute_host and the full
   view within 1 of it, 16 tiles within 1 of compute_host with at most
   1e-3 of their cells differing (the share printed again with
   HillShade's divisions by the plain division, as before device.divide),
   and get_data equal to evaluate_tiled;
6. the raster-algebra paths (build_algebra_paths): elemwise,
   reclassify-chain, combine, place and reproject-bilinear at 8192^2 in
   512^2 tiles, batches of 64.  Every node that returns pixels runs on
   the card; a 64^2 crop and 16 sampled tiles equal compute_host bit for
   bit, but for the cross-CRS bilinear path, whose blends differ in the
   last bits (within BILINEAR_ATOL, and nodata in the same cells);
7. the temporal paths (build_temporal_paths), with the checks of 6 and
   bitwise: temporal-mean (benchmarks/run.py's "temporal+zonal" view over
   8192^2 x 8 hourly frames), temporal-median (MovingMax over 6-hourly
   medians in Amsterdam across the switch to summer time, 4096^2 x 48
   frames; the moving-max kernel launches on it) and temporal-cumulative
   (Snap, Cumulative with a daily reset in Amsterdam, Resample, Shift);
   sources with 5% nodata; 8 sampled tiles, not 16, for the two 48-frame
   paths; and the 90th percentile on a 64^2 crop within
   rtol 1e-6, its differing cells counted.  A zone the system zone
   database lacks fails the run;
8. the tiled geometry paths (build_geometry_paths), with the checks of
   6 and bitwise: rasterize-wkt (Clip of an 8192^2 source by RasterizeWKT
   of a 600-vertex polygon with a hole, both static at 1970-01-01; the
   parity twin timed over one batch) and rasterize (Add(Rasterize(256
   parcels, "code"), 1) at 2048^2: a host node per tile, its results
   stacked into the Add twin; its polygons burned natively, never by
   the numpy scanline, and on each tile the native burn bitwise equal to
   the numpy scanline's);
9. zonal: the zonal half of benchmarks/run.py's temporal+zonal config
   (build_zonal_views: 4096 star-shaped parcels and 16 smaller than a
   cell over the temporal-mean view, MockGeometry's copy as the source):
   AggregateRaster's mean, median, p90 and max, a coarsened sum, the
   threshold variant's count and the mean requested in EPSG:3857, on the
   card against compute_host over an 8 x 8-cell sub-area, every
   request's truth from one compute graph whose shared nodes run once
   (zonal_host_truths; count, max,
   median and p90 bitwise, sum and mean within one float32 ulp; the whole
   mean request's label planes bitwise to the host scanline's and the
   uncovered sets equal), seconds per request,
   the phases of one run, the device plane's CUDA-event times, the idle
   share and the peak memory;
10. the file paths (build_file_paths), Smooth(RasterFileSource(sheet), 3):
   file-read (the whole sheet at its grid, 500 tiles read window by
   window: at most 8 batches, the Gaussian once per batch, bitwise with
   the checks of 6, the crop and a sampled tile at the nodata block, an
   edge tile sampled; no second whole run through get_data, which
   file-reproject holds to evaluate_tiled for the same view) and file-reproject (a 4096^2 sub-area in EPSG:3857,
   at most 5e-4 of the cells differing, as the headline); then
   zarr-store (check_zarr_store): the sheet written as an xarray-style
   Zarr v2 store of 512^2 zlib chunks (write_sheet_zarr), file-read's
   view and request over it with the checks of 6 (8 sampled tiles, no
   second get_data run), bitwise, every cell
   equal to file-read's, every tile read chunk-wise by window and
   ``info`` decoding no data chunk (the seconds of the stamp, the store's
   metadata and the chunk reads inside "plan"), to_zarr of a 2048^2
   sub-area read back equal to the card's answer in EPSG:28992, and a
   chunk rewritten in place seen by a cached window read; then
   file-export (check_file_export): to_file in 2048^2 tiles (35 files, a
   Gaussian launch each), the VRT read back window by window equal to the
   files and to file-read but within the Gaussian's reach of a 512^2 tile
   border, two files equal to compute_host, and to_cog of a 4096^2
   sub-area with overviews (2, 4, 8), read at overview level 2 with
   geomodeling.use-overviews, equal to compute_host;
10b. building-heights (check_buildings): 20,000 synthetic building
   footprints over the sheet (write_buildings: a GeoPackage, layer
   "pand", with its R-tree), the mean and 90th percentile of the file-read
   view per building (AggregateRaster), Round, Classify of their
   difference, Area (build_buildings_view), exported by to_file in
   1000 m tiles (GeometryTiler over GeometryFileSink GeoPackages, merged)
   over a block of 3 x 3 of the tiles (export_block): every building
   whose centroid lies strictly inside a tile of the block, each once;
   two tiles equal to compute_host (h_mean within one float32 ulp before
   rounding); the export again through the GeoPackage's R-tree over the
   same block; a 1000 m
   sub-area exported untiled as GeoJSON and as a Shapefile equal to the
   host's export; one Gaussian launch per tile, the phases, the device
   busy time and idle share;
10c. wms-serving (check_wms_serving): the port's WSGI WMS server
   (ipyleaflet_plugin.wms_app on wsgiref at 127.0.0.1, a background
   thread) over two registered layers of the sheet, ahn-smooth (the
   file-read view, style terrain, 0-10) and ahn-hillshade
   (HillShade(RasterFileSource), gray, 0-255); a slippy map's GetMap
   traffic (every 256^2 EPSG:3857 XYZ tile of zooms 14 and 15 over the
   sheet and the middle one of zoom 16's 18 rows, PNG) through urllib in
   four passes: cold (read caches cleared, no
   result cache), warm, fill (the 256 MiB result cache of wms_serve) and
   hit (byte-identical PNGs, no Gaussian launch); p50/p99/max latency a
   layer and pass; 16 sampled tiles a layer against compute_host (at
   most 5e-4 of the warped source cells differing, outside their reach
   ahn-smooth bitwise and ahn-hillshade within 1 in at most 1e-3 of the
   cells, every pixel whose value agrees coloured as the host's render
   colours it; ahn-hillshade's differing share printed with and without
   device.divide), each timed in-process on the card (render_wms_tile) and
   on the numpy host alike; 16 GetFeatureInfo answers against the host's values,
   GetLegendGraphic, GetCoverage read back, GetCapabilities, a layer
   naming the JAX package's classes answered 400; four threads rendering
   64 tiles as the serial render does, one Gaussian launch per
   ahn-smooth tile; a phase split of the sampled tiles and a profiled
   warm pass of ahn-smooth, apart from the timed ones;
10d. auto-routing (check_auto_routing): geomodeling.executor "auto" over
   the two WMS layers at the sheet's grid and the headline view at its
   request's cell in EPSG:3857: 8 requests of each edge 64, 128, 256,
   512, 1024 and 2048 px a view, at windows drawn from a seed, in one
   seeded, interleaved order, the router exploring from an empty table
   whose state file lives in the temporary folder; the first card-routed
   answer of each view and edge against compute_host (tile by tile above one 512^2 tile, as
   the card runs it; the file-read view bitwise, HillShade
   within 1 in at most 1e-3 of its cells, the headline at most 5e-4 of
   its cells differing); per view and edge the routes taken, the
   Gaussian launches on each route (none on host routes), the final
   host and card Mpx/s and the settled route; after save and a reseeded
   reset, one request per key takes its settled route;
   status.snapshot(); a 2048^2 request under the Profiler and
   torch_trace (a non-empty Chrome trace);
10e. building-rings (check_building_rings): the building-heights
   footprints inside an 800 m square of the sheet (about 400, cut from
   the sheet's 20,000: the host buffer costs tens of ms a footprint),
   written with a beschrijving of key=value lines; the view
   (build_rings_view) buffers each by 10 m, subtracts the footprint,
   simplifies, takes the mean and p10 of the file-read view over the
   ring (the Gaussian and the device zonal plane), merges (left) the
   footprint's own mean, parses two keys, takes a field difference and
   clips each ring to its tile (Intersection); exported by to_file in
   400 m tiles (RINGS_TILE), timed under a phase clock (buffer, difference, vector
   read, zonal, sink); one tile against compute_host and a 300 m
   sub-area exported as GeoJSON byte-identical to the host's export;
10f. building-formats (check_building_formats): the 20,000 footprints
   written as GML (layer pand, srsName EPSG:28992, as BGT and BAG
   extracts arrive), build_buildings_view over GeometryFileSource of the
   GML, exported by to_file in 1000 m tiles into GML partials merged into
   one GML over the same block of 3 x 3 tiles, every row equal to
   building-heights' GeoPackage export and
   one tile to compute_host, timed under the export clock; then the
   building-rings square's footprints written as SpatiaLite, a zipped
   shapefile and DXF (in RD), MIF/MID, TopoJSON, KML and KMZ (in
   EPSG:4326), OSM (write_osm, layer multipolygons) and GPX (the outer
   rings as tracks through a 1 m Buffer), each read back through
   GeometryFileSource and asked once for the whole square on the card:
   the ones that keep RD coordinates equal to the GML view's answer, the
   others to compute_host of their view; one Gaussian launch per
   tile and per format;
10g. dem-formats (check_dem_formats): a synthetic SRTM1 tile over
   Eindhoven and Nijmegen, N51E005.hgt (3601^2 int16 metres, smooth
   terrain, noise and voids), under Classify(MovingMax(Smooth(source,
   100 m), 3), bins) (build_dem_view): (a) asked whole at its own grid
   in EPSG:4326 in 512^2 tiles, every tile bitwise equal to compute_host,
   the Gaussian's integer entry and the moving max launched on its int16
   frames; (b) asked in RD New at 4096^2 of 25 m, with the checks of 6
   and the headline's 5e-4 share; (c) the heights written as DTED, ENVI
   (.bil), Surfer, SAGA and Idrisi at 3601^2 and, decimated to SRTM3's
   1201^2, as an .hgt, an Esri ASCII grid and XYZ: each read back and
   asked once on the card, 8 sampled tiles bitwise to compute_host, the
   integer formats' answers equal to the .hgt view's; write, read, card
   and host seconds a format; both kernels on int16 frames of (b)'s and
   (a)'s batch shapes torch.equal to their plain versions;
10h. netcdf-radar (check_netcdf_radar): a day of a rain radar's 5-minute
   frames over the Netherlands, 288 records of 500^2 cells of 1 km in RD
   New, as a hand-built CDF-2 file (write_radar_netcdf: int16 rain packed
   with a scale_factor and 5% fill, int8 quality and the time interleaving
   record by record, y ascending, the CRS from a grid mapping's
   epsg_code), under Smooth(TemporalAggregate(source, "1h", sum), 3 km)
   (build_radar_view): (a) 4096^2 of 100 m over three afternoon hours (36
   frames, 3 bands) in 64 tiles, with the checks of 6 bitwise on 8 sampled
   tiles, the zoom-mode Gaussian's two launches a batch and its batch
   shape, the whole decode and the first run timed; (b) the same request
   read by window under a lowered geomodeling.windowed-read-limit, bitwise
   the whole-file answer; (c) the quality variable's view on a tile
   against compute_host and unlike the rain's, info of both equal to the
   whole decode; (d) write_netcdf of one hourly sum over 1024^2, packed
   int16, read back within half a packing step; (e) the h5py gate on an
   HDF5 .nc4, and an HDF4 .hdf of no data set reaching the HDF4 reader
   and its ValueError; the Gaussian at the
   path's batch shape torch.equal to its plain version;
10i. hfa-roughness (check_hfa_roughness): a land-use grid in the style of
   LGN over a water board's 40 x 30 km, 8000 x 6000 uint8 classes of 5 m
   in RD New (lgn_classes: parcels of about 20 x 60 cells of about 40 LGN
   classes, towns of built-up classes cell by cell, class 0 the sea over a
   tenth), written with the port's write_hfa in 64^2 blocks, every block
   whose ESRI-GRID-RLE form is shorter spliced into it (splice_rle), and a
   PAM sidecar (lgn.img.aux.xml) whose attribute table gives each class
   but two a Manning's n (write_lgn); under Smooth(Reclassify(source, the
   table's MANNING, select=True), 25 m) (build_lgn_view), asked whole at
   its own grid: 192 tiles in batches of 64, with the checks of 6 bitwise
   on 8 sampled tiles; info and the whole decode timed (every spliced
   block decoded once, no second read); the friction on a coast tile
   nodata exactly at class 0 and the unlisted classes; a rewritten
   sidecar changes the next view's answer, as compute_host's; Mpx/s,
   median of 3 runs, and their phases; the Gaussian's first launch on the
   path torch.equal to its plain version on the same frames;
10j. tile-pyramids (check_tile_pyramids): hfa-roughness' chain over the
   same land use delivered as raster tile pyramids, the attribute table
   passed in (a pyramid has no PAM sidecar; build_pyramid_view): (a)
   hfa-roughness' classes as a GeoPackage of 256^2 PNG tiles in RD New
   (write_lgn_gpkg, the port's write_gpkg_raster), asked at
   hfa-roughness' request: info and the first run decode the file once,
   every tile once; no windowed read; a 64^2 corner and a sampled tile
   bitwise to compute_host; every cell equal to hfa-roughness' answer;
   the Gaussian once a batch, its first launch torch.equal to its plain
   version; Mpx/s, median of 3 runs; (b) the land use drawn at the size
   of the zoom-14 tile-aligned Web Mercator box around the request's
   footprint, written as MBTiles (write_lgn_mbtiles, the port's
   write_mbtiles), asked at the same RD New request (a cross-CRS nearest
   read): 8 sampled tiles within 5e-4 of compute_host, the decoded
   mosaic equal to the classes written (the TMS row flip), one run
   timed; (c) (a)'s view pickled and unpickled keeps its token and
   answers a tile as the original does on the card; (d) a GeoPackage of
   features, an animated WebP tile and an MBTiles of vector tiles refused
   with the JAX package's errors;
10k. modis-ndvi (check_modis_ndvi): a synthetic MOD13Q1-style 16-day
   vegetation index tile, h18v03 (the Netherlands to the Baltic), 4800^2
   cells of 231.66 m in the MODIS sinusoidal grid, as an HDF4 file in the
   SD API's layout (write_modis_hdf4: NDVI, EVI and pixel reliability,
   int16 with _FillValue and scale_factor, each a chunked element of kind
   5 in 480^2 deflate chunks; StructMetadata.0's sinusoidal grid), under
   Classify(Smooth(source, 500 m), NDVI bins) (build_modis_view) with the
   windowed-read limit lowered below the tile: info from the header alone;
   (a) the tile's own grid in 512^2 tiles, each read by window decoding
   only the chunks it touches, every tile bitwise to compute_host, the
   Gaussian on float64 frames once a batch, its first launch torch.equal
   to its plain version; sampled windows equal to a whole read_hdf4,
   which holds the values written and the sinusoidal georeference; (b)
   the Netherlands in RD New at 100 m (2800 x 3300), with the checks of 6
   and the headline's 5e-4 share; a truncated and an empty file raise the
   reader's ValueError;
10l. grib-forecast (check_grib_forecast): the cookbook's recipe 1 over 48
   hourly rain fields of a 0.02 degree regional forecast on a grid the
   size of ICON-D2's (1215 x 746 points from 3.94 W, stored as 356.06 E),
   as GRIB2 (write_forecast_grib: template 3.0, APCP under template 4.8,
   24 fields in simple packing and 24 in complex packing with second-order
   spatial differencing in tens of thousands of groups each), under
   Classify(Smooth(TemporalAggregate(source, 3h, sum), 3 km), bins)
   (build_grib_view): the whole read timed and held to the values
   written, mode "meta" to compute_host; (a) the file's own grid over the
   48 hours, 16 three-hour sums, every tile bitwise to compute_host, the
   Gaussian on float64 frames a batch a sigma, torch.equal to its plain
   version; (b) recipe 1's bbox in RD New at 100 m over 24 hours with the
   checks of 6 and the headline's 5e-4 share; recipe 1's to_cog at 500 m
   read back equal to get_data; a truncated message and a broken section
   length raise ValueError, template 5.40 NotImplementedError naming
   io/grib.py; recipe 8's GRIB1 archive (IBM-float reference) under
   MaskBelow bitwise to compute_host;
10m. parcel-imagery (check_parcel_imagery): a commercial 4-band scene
   (blue, green, red, near-infrared; 11 bits in 16) of 5120^2 pixels of
   about 2 m over Flevoland as NITF 2.1 (write_scene_nitf: IMODE B in
   1024^2 blocks, IC = NM with the north-east and south-west corner
   blocks outside the acquisition strip masked out, ICORDS G corners at
   whole arcseconds), its NDVI (the near-infrared band brought to the red
   band's time by Shift, the band sum masked below 1) smoothed over 15 m,
   clipped to the data and classified (build_scene_view): (a) info from
   the headers and the whole read held to the values written; (b) the
   scene's own grid in 512^2 tiles, nodata exactly on the absent blocks,
   16 tiles bitwise to compute_host, the Gaussian on float64 frames
   torch.equal to its plain version; (c) 4,096 field parcels of about
   150 m in RD New (field_frame) written as FlatGeobuf with its packed
   R-tree and read through it by GeometryFileSource above a lowered
   geomodeling.vector-windowed-read-limit: the mean and p90 of the
   smoothed NDVI per parcel over the scene in EPSG:4326, both over a
   sub-area against compute_host (mean within one float32 ulp, p90
   bitwise), a GeoPackage copy's answers there bitwise equal; (d) to_file
   of the parcels with their mean in 3 x 3 tiles into FlatGeobuf partials
   merged into one, read back equal to the partials, its R-tree search
   equal to a box filter; (e) a JPEG 2000 (C8) segment, a truncated NITF
   and a FlatGeobuf of a bad magic refused with the JAX package's errors;
10n. lzw-sheet (check_lzw_sheet): (a) the sheet as a tiled LZW GeoTIFF
   (write_lzw_sheet: 512^2 tiles, predictor 1, encoded as libtiff does
   by chip_smoke_encoders.cpp) under file-read's view and request, 500
   tiles read by window, every cell equal to file-read's, every chunk
   decoded natively on the codec's pool (their count, MB, MB/s and the
   most at once), none by the pure-Python decoder, which is timed apart
   on 64 KiB of the central tile; (b) hfa-roughness' classes as a
   stripped PackBits GeoTIFF (write_lgn_packbits) under its chain, every
   cell equal to hfa-roughness' answer; (d) a HostPool of two local
   worker processes, started as the phase begins, answering sampled
   tiles' graphs equal to compute_host, its /status.json read, every
   worker stopped; the first Gaussian of (a) and (b) torch.equal to its
   plain version;
10o. ortho-jpeg (check_ortho_jpeg): (e) the JPEG codec's fixtures of
   tests/data/torch_jpeg decoded and three arrays encoded natively, each
   SHA-256 the one recorded from Pillow; (a) an 8192^2 RGB orthophoto of
   0.25 m as a JPEG GeoTIFF in GDAL's COMPRESS=JPEG PHOTOMETRIC=YCBCR
   layout (write_jpeg_geotiff: 512^2 abbreviated 4:2:0 tiles from the
   port's encoder, JPEGTables) under build_ortho_view (the excess-green
   index of the bands as frames, smoothed over 1 m, classified), 256
   tiles read by window, sampled tiles bitwise to compute_host, every
   chunk decoded natively (count, MB, MB/s, most at once); (b) a 2048^2
   sub-area as a GeoPackage of 256^2 JPEG tiles and as zoom-18 MBTiles,
   asked in RD New, bitwise; (c) 48 image/jpeg GetMaps of zooms 17-19
   from the WSGI server, cold and warm, each body the encoder's bytes of
   compute_host's pixels (a tile whose card values part from the host's
   within HEADLINE_SHARE: of the card's), p50/p99 and the encode's
   share; (d) a .jpg with world file, .prj and PAM nodata, two BMPs, a
   GIF and a C3/M3 NITF, each read whole and bitwise (the NITF also at
   half resolution, where every cell centre is a tie of four pixels:
   tie_report's cells of another class and index cells both 0); the
   first Gaussian of (a) torch.equal to its plain version;
10p. ortho-webp (check_ortho_webp): (e) the WebP codec's fixtures of
   tests/data/torch_webp, lossless and lossy (ortho-lossy's five 512^2
   chunks among them), decoded natively, each SHA-256 the one recorded
   from Pillow's array; (f) an animated fixture refused with
   NotImplementedError naming the JAX modules, a truncated lossless and a
   truncated lossy file with OSError; (a) ortho-jpeg's 8192^2 orthophoto
   written by the port's write_geotiff(compress="webp", tiled, 512^2):
   768 native lossless encodes, the file's share of the raw bytes against
   deflate's on 16 sampled chunks; (b) build_ortho_view over it by
   window, every decoded window equal to the pixels written, sampled
   tiles bitwise to compute_host, only the native WebP decoder running;
   (c) a 2048^2 sub-area as a GeoPackage of 256^2 WebP tiles (one RGBA)
   and as zoom-18 MBTiles, every tile decoding to the pixels written,
   every tile of each answer bitwise to compute_host; (d) a contiguous
   RGB WebP GeoTIFF in GDAL's layout (write_tiff_layout) read whole and
   by window, equal to the pixels; (g) an 8192^2 RGB lossy WebP GeoTIFF
   in GDAL's layout (COMPRESS=WEBP's lossy default, quality 75: 256 tiles
   of ortho-lossy's four RGB chunks repeated) under the same view by
   window, every decoded window equal to the truth assembled from the
   checked chunks, sampled tiles bitwise to compute_host, only the native
   WebP decoder running, and a 4-band file of the RGBA chunk read whole
   and by window; the first Gaussian of (b) and of (g) torch.equal to its
   plain version;
11. the executor fuzz on the card: the 55 random trees of
   tests/test_executor_fuzz.py (random_view, with the port's classes)
   against compute_host; and float64 comparisons, MaskBelow, Step and
   Classify at and beside their thresholds, bitwise;
12. timing, per tiled path (border-reproject's plan seconds beside the
   headline's): median of 3 evaluate_tiled runs (Mpx/s) and the median
   run's seconds per phase, the numpy host rate on the sampled tiles, one
   profiled run's device busy time and idle share; per kernel at its
   path's shape, the kernel, its plain version and one PyTorch call of the
   same function (CUDA events), and the least time the card could take;
   the Gaussian is timed at three paths' shapes, on a uint8 batch (the
   integer entry) and at the building-heights and wms-serving paths'
   single planes, both kernels on dem-formats' int16 batch, and the
   Gaussian on netcdf-radar's zoom-mode batch, on hfa-roughness' float64
   batch, on grib-forecast's first float64 batches of (a) and (b), on
   parcel-imagery's first float64 batch, on lzw-sheet's first batches
   of (a) and (b), on ortho-jpeg (a)'s and on ortho-webp (b)'s first
   batch, one kernel record
   each; the rasterize path's plan with
   the numpy scanline, one run, beside the native burn's.

The views are built with the port's own classes (private copies of
bench.py's and benchmarks/run.py's builders) and checked against the
port's compute_host.  The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.  Without CUDA the
script exits non-zero before printing any result.  It imports nothing of
JAX, pandas, matplotlib, Pillow, flatbuffers or the JAX package, and
checks that at the end.
"""
import functools
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from datetime import datetime, timedelta

import numpy as np

HEADLINE_PX = 10240
HEADLINE_SHARE = 5e-4
STENCILS_PX = 8192
STENCILS_SHARE = 1e-3
# the raster-algebra paths: 8192^2 same-CRS (and one EPSG:3857) requests
ALGEBRA_PX = 8192
# the cross-CRS bilinear path interpolates the approximate transformer's
# coarse grid where the host transforms every pixel, so its blends differ
# from the host's in the last bits; its limits are the JAX package's own
# bilinear tolerance (tests/test_warp_bilinear.py) on the largest
# difference, and the headline's share on cells that are nodata in one
# and data in the other
BILINEAR_ATOL = 1e-3
BILINEAR_FILL_SHARE = 5e-4
# the temporal paths: an 8192^2 source of 8 hourly frames, and a 4096^2
# source of 48 hourly frames across the switch to summer time in
# Amsterdam; 5% of their cells hold nodata, and so does a top-left
# 600^2 square (the 64^2 corner and one sampled tile) in the frames of
# the first 4h bin of the one and the first four 6h bins of the other,
# so that those bins hold no data there
TEMPORAL_MEAN_PX = 8192
TEMPORAL_PX = 4096
NODATA_SHARE = 0.05
NODATA_SQUARE = 600
DST_WINDOW = (datetime(2000, 3, 25), datetime(2000, 3, 27))
FUZZ_SEEDS = range(40)
FUZZ_TILED_SEEDS = range(40, 55)
TILE = 512
BATCH = 64
# NVIDIA H100 SXM data sheet: HBM3 rate, and the FP32 and FP64 rates
# outside the tensor cores.  The data sheet's 34 TFLOP/s of FP64 counts a
# fused multiply-add as two operations; the kernels are built with
# -fmad=false, so each multiply and each add is an instruction of its own,
# and 17e12 of them a second is the rate they can reach.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 17e12
# integer comparisons: 64 INT32 lanes a multiprocessor (half the FP32
# lanes), 132 multiprocessors at the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


# --- the views, with the port's own classes ---


def build_headline_view(source_px=8192, projection="EPSG:28992", origin=(85000, 455000),
                        cell=1.0):
    """bench.py:build_view: Classify(Reclassify(Classify(Smooth(source + 1))))
    over an 8192^2 float32 source of 1 m cells, in EPSG:28992 unless told
    otherwise."""
    from dask_geomodeling_tpu_torch.raster import Classify, MemorySource, Reclassify, Smooth

    rng = np.random.RandomState(42)
    data = (rng.rand(1, source_px, source_px) * 250).astype(np.float32)
    data[0, :64, :64] = np.float32(np.finfo(np.float32).max)  # nodata patch

    source = MemorySource(
        data=data,
        no_data_value=float(np.finfo(np.float32).max),
        projection=projection,
        pixel_size=cell,
        pixel_origin=origin,
        time_first=datetime(2000, 1, 1),
        time_delta=timedelta(hours=1),
    )
    view = Classify(
        Reclassify(
            Classify(Smooth(source + 1, size=3), bins=[50.0, 100.0, 150.0, 200.0]),
            data=[[0, 1], [1, 5], [2, 9], [3, 13], [4, 17]],
        ),
        bins=[4, 8, 12, 16],
    )
    return source, view


def headline_request(source, out_px):
    """bench.py:full_request: the source's extent in EPSG:3857."""
    from dask_geomodeling_tpu_torch.geo import Extent

    bbox = (
        Extent(
            source.geo_transform.get_bbox((0, 0), source.data.shape[1:]),
            source.projection,
        )
        .transformed("EPSG:3857")
        .bbox
    )
    return dict(
        mode="vals",
        bbox=bbox,
        projection="EPSG:3857",
        width=out_px,
        height=out_px,
        start=datetime(2000, 1, 1),
    )


# border-reproject: a water board on the Dutch-German border takes the
# German 1 m elevation model (ETRS89 / UTM 32N) into RD New; the source
# lies over Gronau (about 7.0 E, 52.2 N), its top-left corner here
BORDER_ORIGIN = (362000.0, 5792000.0)


def build_border_view(source_px=8192, cell=1.0):
    """The headline's chain over a float32 source in EPSG:25832, sent
    through JSON as a service registers a layer: (built view, the view
    Block.from_json loads)."""
    from dask_geomodeling_tpu_torch import Block

    _, view = build_headline_view(source_px, "EPSG:25832", BORDER_ORIGIN, cell)
    return view, Block.from_json(view.to_json())


def border_request(view, out_px):
    """The view's footprint in EPSG:28992, at out_px^2."""
    from dask_geomodeling_tpu_torch.geo import Extent

    bbox = Extent.from_geometry(view.geometry).transformed("EPSG:28992").bbox
    return dict(mode="vals", bbox=bbox, projection="EPSG:28992", width=out_px,
                height=out_px, start=datetime(2000, 1, 1))


#: crs-families: (label, CRS, (lon, lat) of the source's centre inside its
#: area of use), one projection family each; the last has no EPSG code
CRS_FAMILIES = (
    ("lcc-2sp", "EPSG:2154", (3.0, 46.5)),
    ("lcc-belgium", "EPSG:31370", (4.4, 50.8)),
    ("laea", "EPSG:3035", (10.0, 52.0)),
    ("albers", "EPSG:5070", (-96.0, 40.0)),
    ("polar-stereographic", "EPSG:3413", (-45.0, 70.0)),
    ("krovak", "EPSG:5514", (15.5, 49.8)),
    ("hotine-swiss", "EPSG:2056", (8.2, 46.8)),
    ("tm-osgb36", "EPSG:27700", (-1.5, 52.5)),
    ("mercator", "EPSG:3395", (0.0, 10.0)),
    ("proj4-utm", "+proj=utm +zone=31 +ellps=GRS80 +units=m +no_defs", (3.0, 52.0)),
)
FAMILY_PX = 1024
FAMILY_CELL = 10.0
#: the NTv2 request: an RD New source over Amersfoort, with a grid
#: registered for the Amersfoort datum
NTV2_PLACE = ("EPSG:28992", (5.39, 52.16))


def build_family_view(projection, place, px=FAMILY_PX, cell=FAMILY_CELL, seed=42):
    """The headline's chain over a px^2 float32 source in ``projection``
    centred on ``place`` (lon, lat), with ``cell`` m pixels; returns
    (view, its px^2 request in EPSG:3857 over the source's footprint)."""
    from dask_geomodeling_tpu_torch.geo import Extent, transform_points
    from dask_geomodeling_tpu_torch.raster import Classify, MemorySource, Reclassify, Smooth

    (cx,), (cy,) = transform_points([place[0]], [place[1]], "EPSG:4326", projection)
    half = px * cell / 2
    rng = np.random.RandomState(seed)
    data = (rng.rand(1, px, px) * 250).astype(np.float32)
    data[0, :64, :64] = np.float32(np.finfo(np.float32).max)
    source = MemorySource(data=data, no_data_value=float(np.finfo(np.float32).max),
                          projection=projection, pixel_size=cell,
                          pixel_origin=(float(cx) - half, float(cy) + half),
                          time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))
    view = Classify(
        Reclassify(
            Classify(Smooth(source + 1, size=3), bins=[50.0, 100.0, 150.0, 200.0]),
            data=[[0, 1], [1, 5], [2, 9], [3, 13], [4, 17]],
        ),
        bins=[4, 8, 12, 16],
    )
    bbox = Extent.from_geometry(source.geometry).transformed("EPSG:3857").bbox
    return view, dict(mode="vals", bbox=bbox, projection="EPSG:3857", width=px, height=px,
                      start=datetime(2000, 1, 1))


def _gsb_record(name, payload):
    return name.ljust(8).encode("ascii") + payload


def write_ntv2(path, s_lat, n_lat, e_long, w_long, inc, shift_fn):
    """A little-endian single-sub-grid NTv2 file, as tests/test_ntv2.py
    builds them: bounds and increment in arc-seconds (longitudes positive
    west); shift_fn(lon_deg, lat_deg) -> (lat shift, west lon shift) in
    arc-seconds, over arrays of the nodes."""
    import struct

    def int_rec(name, value):
        return _gsb_record(name, struct.pack("<i", value) + b"\x00" * 4)

    def float_rec(name, value):
        return _gsb_record(name, struct.pack("<d", value))

    def text_rec(name, text):
        return _gsb_record(name, text.ljust(8).encode("ascii")[:8])

    n_rows = int(round((n_lat - s_lat) / inc)) + 1
    n_cols = int(round((w_long - e_long) / inc)) + 1
    header = b"".join([
        int_rec("NUM_OREC", 11), int_rec("NUM_SREC", 11), int_rec("NUM_FILE", 1),
        text_rec("GS_TYPE", "SECONDS"), text_rec("VERSION", "NTv2.0"),
        text_rec("SYSTEM_F", "TESTSRC"), text_rec("SYSTEM_T", "WGS84"),
        float_rec("MAJOR_F", 6378388.0), float_rec("MINOR_F", 6356911.9),
        float_rec("MAJOR_T", 6378137.0), float_rec("MINOR_T", 6356752.3),
        text_rec("SUB_NAME", "TEST"), text_rec("PARENT", "NONE"),
        text_rec("CREATED", "now"), text_rec("UPDATED", "now"),
        float_rec("S_LAT", s_lat), float_rec("N_LAT", n_lat),
        float_rec("E_LONG", e_long), float_rec("W_LONG", w_long),
        float_rec("LAT_INC", inc), float_rec("LONG_INC", inc),
        int_rec("GS_COUNT", n_rows * n_cols),
    ])
    # rows south to north, columns east to west
    lat = (s_lat + np.arange(n_rows) * inc)[:, None] / 3600.0
    lon = -(e_long + np.arange(n_cols) * inc)[None, :] / 3600.0
    dlat, dlon = shift_fn(np.broadcast_to(lon, (n_rows, n_cols)),
                          np.broadcast_to(lat, (n_rows, n_cols)))
    nodes = np.zeros((n_rows, n_cols, 4), "<f4")
    nodes[..., 0], nodes[..., 1], nodes[..., 2:] = dlat, dlon, 0.1
    with open(path, "wb") as f:
        f.write(header + nodes.tobytes())


def write_amersfoort_grid(path):
    """An NTv2 grid over the Netherlands (50-54 N, 3-8 E, 0.25 degree
    nodes) for the Amersfoort datum: the Helmert shift to WGS84 at each
    node plus a smooth field of up to 0.05 arc-seconds, so that it moves
    points by up to about 1.5 m from the Helmert answer."""
    from dask_geomodeling_tpu_torch.geo import transform_points

    def shift(lon, lat):
        wlon, wlat = transform_points(lon.ravel(), lat.ravel(), "EPSG:4289", "EPSG:4326")
        dlat = (wlat.reshape(lat.shape) - lat) * 3600 + 0.05 * np.sin(lon)
        dlon_west = -(wlon.reshape(lon.shape) - lon) * 3600 + 0.05 * np.cos(lat)
        return dlat, dlon_west

    write_ntv2(path, 180000.0, 194400.0, -28800.0, -10800.0, 900.0, shift)


def build_nesting_views(px=1024, frames=6):
    """The two Cumulative nestings whose time subrequest ran through an
    elementwise twin: over a px^2 float32 source of hourly frames with 5%
    nodata; returns ({label: view}, request)."""
    from dask_geomodeling_tpu_torch.raster import Cumulative, TemporalAggregate

    source = make_source(px, seed=7, bands=frames, nodata_share=NODATA_SHARE)
    inner = Cumulative(source + 1.5, statistic="sum")
    views = {
        "aggregate-of-cumulative": TemporalAggregate(inner, "2h", statistic="sum"),
        "cumulative-of-cumulative": Cumulative(inner, statistic="sum"),
    }
    return views, dict(vals_request(px), stop=datetime(2000, 1, 1, frames - 1))


def make_source(px, seed=0, bands=1, time_first=datetime(2000, 1, 1), nodata_share=0.0,
                nodata_block=(0, 0), parallel=False):
    """benchmarks/run.py:make_source: float32 uniform [0, 200), hourly
    frames when bands > 1.  With ``nodata_share``, that share of the cells,
    drawn by a PCG64 generator of the same seed, holds nodata.  Drawn in
    blocks of rows (the same numbers as one (bands, px, px) draw) to keep
    the host's transient memory in the cache.  With ``nodata_block`` = (frames,
    size), the first ``frames`` frames hold nodata in the top-left size^2
    square as well.  ``parallel`` draws other numbers of the same
    distribution, for a source no reference view shares: each band from
    PCG64 generators of its own (spawned from (seed, 200): its values, then
    its nodata cells), as float32, the bands on a thread pool (the one
    MT19937 stream took 28-31 s of the 1.3 G values of the temporal sources
    on an NVIDIA H100 80GB HBM3 machine's host)."""
    from concurrent.futures import ThreadPoolExecutor

    from dask_geomodeling_tpu_torch.raster import MemorySource

    nodata = np.finfo(np.float32).max
    data = np.empty((bands, px, px), np.float32)
    rows = 256  # draws of 256 rows: the same numbers, in the cache
    if parallel:
        def draw(band, seeds):
            values, cells = (np.random.default_rng(s) for s in seeds.spawn(2))
            for row in range(0, px, rows):
                block = data[band, row:row + rows]
                values.random(block.shape, dtype=np.float32, out=block)
                block *= np.float32(200)
                if nodata_share:
                    np.copyto(block, nodata,
                              where=cells.random(block.shape, dtype=np.float32) < nodata_share)

        streams = np.random.SeedSequence([seed, 200]).spawn(bands)
        with ThreadPoolExecutor(max_workers=min(bands, os.cpu_count() or 1)) as pool:
            list(pool.map(draw, range(bands), streams))
    else:
        rng = np.random.RandomState(seed)
        for band in range(bands):
            for row in range(0, px, rows):
                data[band, row:row + rows] = rng.rand(min(rows, px - row), px) * 200
        if nodata_share:
            cells = np.random.default_rng(seed)
            for band in range(bands):
                for row in range(0, px, rows):
                    block = data[band, row:row + rows]
                    block[cells.random(block.shape, dtype=np.float32) < nodata_share] = nodata
    frames, size = nodata_block
    data[:frames, :size, :size] = nodata
    return MemorySource(
        data=data,
        no_data_value=float(nodata),
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=time_first,
        time_delta=timedelta(hours=1) if bands > 1 else None,
    )


def vals_request(px):
    """benchmarks/run.py:vals_request: the source's extent at px^2."""
    return dict(
        mode="vals",
        bbox=(135000.0, 456000.0 - px, 135000.0 + px, 456000.0),
        projection="EPSG:28992",
        width=px,
        height=px,
        start=datetime(2000, 1, 1),
        stop=datetime(2000, 1, 2),
    )


def build_stencils_view(px=8192):
    """The "stencils" configuration of benchmarks/run.py."""
    from dask_geomodeling_tpu_torch.raster import HillShade, MovingMax, Smooth

    source = make_source(px)
    return source, HillShade(Smooth(MovingMax(source, 3), 5))


def warp_request(px):
    """benchmarks/run.py's cross-CRS request: vals_request(px)'s bbox in
    EPSG:3857, at px^2."""
    from dask_geomodeling_tpu_torch.geo import Extent

    request = vals_request(px)
    return dict(
        request,
        projection="EPSG:3857",
        bbox=Extent(request["bbox"], "EPSG:28992").transformed("EPSG:3857").bbox,
    )


def build_algebra_paths(px=8192):
    """The raster-algebra paths: {name: (view, request, interpolation,
    corner)} over sources a and b (make_source with seeds 0 and 2), where
    ``corner`` is the top-left point of the 64^2 crop held to compute_host
    (the request's own, but for place the first placement's centre).

    - elemwise and reclassify-chain: benchmarks/run.py's views;
    - combine: Group, Max, Dilate, Clip, FillNoData, Power, Divide, Step
      and a comparison in one view.  Max always holds data, so it is the
      Group's first member and the dilated classes, which hold data only
      where the Clip kept a, show over it;
    - place: a's top-left 256 m square, as a source of its own, placed at
      the 4x4 grid of the request's cell centres with the maximum over
      overlaps.  A store no larger than a tile makes the Place plan its
      warp mode (one fetch of the store, pasted per coordinate); a's
      whole 8192^2 would plan per-coordinate requests, which differ from
      tile to tile;
    - reproject-bilinear: Add(a, 1) over the cross-CRS request, with
      bilinear resampling.
    """
    from dask_geomodeling_tpu_torch.raster import (
        Add, Classify, Clip, Dilate, FillNoData, Greater, Group, Mask, MaskBelow, Max,
        MemorySource, Multiply, Place, Power, Reclassify, Step,
    )

    a = make_source(px, seed=0)
    b = make_source(px, seed=2)
    request = vals_request(px)
    square = MemorySource(
        data=a.data[:, :256, :256],
        no_data_value=a.no_data_value,
        projection=a.projection,
        pixel_size=a.pixel_size,
        pixel_origin=a.pixel_origin,
        time_first=a.time_first,
    )
    x0, y0 = a.pixel_origin
    cell = px / 4
    place = Place(
        square,
        "EPSG:28992",
        anchor=[x0 + 128.0, y0 - 128.0],
        coordinates=[[x0 + cell * (i + 0.5), y0 - cell * (j + 0.5)]
                     for j in range(4) for i in range(4)],
        statistic="max",
    )
    combine = Group(
        Max(FillNoData(MaskBelow(a, 10.0), b), Power(b / 10.0, 2), Step(b, left=0, right=1, value=100.0)),
        Dilate(Classify(Clip(a, Greater(b, 100.0)), bins=[50.0, 100.0, 150.0]), values=[1, 3]),
    )
    bilinear = warp_request(px)
    corner = (request["bbox"][0], request["bbox"][3])
    return {
        "elemwise": (Mask(Multiply(Add(a, 1.0), 2.0), 7.0), request, "nearest", corner),
        "reclassify-chain": (
            Reclassify(
                Classify(MaskBelow(a, 10.0), bins=[50.0, 100.0, 150.0]),
                data=[[0, 1], [1, 5], [2, 9], [3, 13]],
            ),
            request,
            "nearest",
            corner,
        ),
        "combine": (combine, request, "nearest", corner),
        "place": (place, request, "nearest", (x0 + cell / 2 - 32, y0 - cell / 2 + 32)),
        "reproject-bilinear": (
            Add(a, 1.0), bilinear, "bilinear", (bilinear["bbox"][0], bilinear["bbox"][3])),
    }


def build_temporal_paths(mean_px=TEMPORAL_MEAN_PX, px=TEMPORAL_PX, nodata_share=NODATA_SHARE):
    """The temporal paths, as build_algebra_paths gives them, and the
    48-frame source they share; sources from make_source with
    ``nodata_share`` of their cells nodata and, where that is not 0, a
    NODATA_SQUARE square of nodata in the frames of their first bins
    (4 of 8 frames; the 23 frames before local midnight of 2000-03-26).

    - temporal-mean: benchmarks/run.py's "temporal+zonal" view,
      TemporalAggregate(source, "4h", statistic="mean") over 8 hourly
      frames from 2000-01-01 (seed 1), requested from 2000-01-01 to
      2000-01-02: two bands;
    - temporal-median: MovingMax(TemporalAggregate(source, "6h",
      statistic="median", timezone="Europe/Amsterdam"), 3) over 48 hourly
      frames from 2000-03-25 00:00 UTC (seed 4), across the switch to
      summer time of 2000-03-26, requested from 2000-03-25 to 2000-03-27:
      bins of 5 and 6 frames, seven bands;
    - temporal-cumulative: Snap(Cumulative(Resample(Shift(source, 30
      min), "2h", direction="backward"), statistic="sum", frequency="D",
      timezone="Europe/Amsterdam"), Resample(source, "6h")) over the same
      source and window: nine bands.
    """
    from dask_geomodeling_tpu_torch.raster import (
        Cumulative, MovingMax, Resample, Shift, Snap, TemporalAggregate,
    )

    square = NODATA_SQUARE if nodata_share else 0
    hourly8 = make_source(mean_px, seed=1, bands=8, nodata_share=nodata_share,
                          nodata_block=(4, square))
    hourly48 = make_source(px, seed=4, bands=48, time_first=DST_WINDOW[0],
                           nodata_share=nodata_share, nodata_block=(23, square), parallel=True)
    request = dict(vals_request(px), start=DST_WINDOW[0], stop=DST_WINDOW[1])
    corner = (request["bbox"][0], request["bbox"][3])
    median = MovingMax(TemporalAggregate(hourly48, "6h", statistic="median",
                                         timezone="Europe/Amsterdam"), 3)
    cumulative = Snap(
        Cumulative(Resample(Shift(hourly48, 1800000), "2h", direction="backward"),
                   statistic="sum", frequency="D", timezone="Europe/Amsterdam"),
        Resample(hourly48, "6h"),
    )
    paths = {
        "temporal-mean": (TemporalAggregate(hourly8, "4h", statistic="mean"),
                          vals_request(mean_px), "nearest", corner),
        "temporal-median": (median, request, "nearest", corner),
        "temporal-cumulative": (cumulative, request, "nearest", corner),
    }
    return paths, hourly48


def mock_geometry_class():
    """tests/factories.py:MockGeometry with the port's classes: an
    in-memory geometry source that ignores the request's bbox and answers
    in the requested projection.  A class of this module, so that its
    import path resolves (graph keys hash it)."""
    global MockGeometry
    if "MockGeometry" in globals():
        return MockGeometry
    from dask_geomodeling_tpu_torch.geo import get_epsg_or_wkt, shapely_transform
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, GeoSeries
    from dask_geomodeling_tpu_torch.geo.geometry import Polygon
    from dask_geomodeling_tpu_torch.geometry import GeometryBlock

    class MockGeometry(GeometryBlock):
        """An in-memory geometry source: all polygons, whatever the
        request's bbox; the projection of the answer is the request's."""

        def __init__(self, polygons, properties=None, projection="EPSG:3857"):
            super().__init__(polygons, properties, projection)

        @property
        def polygons(self):
            return self.args[0]

        @property
        def properties(self):
            return self.args[1]

        @property
        def projection(self):
            return self.args[2]

        @property
        def columns(self):
            result = {"geometry"}
            if self.properties:
                result |= set(self.properties[0].keys())
            result.discard("id")  # 'id' is reserved for the index
            return result

        def get_sources_and_requests(self, **request):
            return [(self.polygons, None), (self.properties, None),
                    (self.projection, None), (request, None)]

        @staticmethod
        def process(polygons, properties, projection, request):
            if request.get("limit") is not None:
                polygons = polygons[: request["limit"]]
                if properties is not None:
                    properties = properties[: request["limit"]]
            mode = request.get("mode", "intersects")
            geometries = [Polygon(x) for x in polygons]
            if get_epsg_or_wkt(projection) != get_epsg_or_wkt(request["projection"]):
                geometries = [shapely_transform(g, projection, request["projection"])
                              for g in geometries]
            geoseries = GeoSeries(geometries, crs=request["projection"])
            if mode == "extent":
                extent = tuple(geoseries.total_bounds) if len(geoseries) else None
                return {"extent": extent, "projection": request["projection"]}
            if len(geoseries) == 0:
                return {"features": GeoDataFrame([]), "projection": request["projection"]}
            if properties is not None:
                df = GeoDataFrame.from_records(properties)
                df = df.set_geometry(geoseries, crs=request["projection"])
                if "id" in df.columns:
                    df.set_index("id", inplace=True)
            else:
                df = GeoDataFrame(geometry=geoseries, crs=request["projection"])
                df.index.name = "id"
            if mode == "centroid":
                df = df[df.geometry.centroid.within(request["geometry"])]
            elif mode == "intersects":
                df = df[df.geometry.intersects(request["geometry"])]
            return {"features": df, "projection": request["projection"]}

    MockGeometry.__module__ = __name__
    MockGeometry.__qualname__ = "MockGeometry"
    globals()["MockGeometry"] = MockGeometry
    return MockGeometry


# the zonal path: 4096 star-shaped parcels on a 64 x 64 grid of 48 m cells
# (radii 20-30 m, so neighbours' bboxes touch or overlap and bucketize
# makes several groups) and 16 smaller than a cell, centred on cell
# corners (centroid sampling), inside the temporal-mean source
PARCEL_GRID = 64
PARCEL_CELL = 48.0
PARCEL_ORIGIN = (137000.0, 454000.0)  # top-left corner, EPSG:28992
SMALL_PARCELS = 16


def make_parcels(grid=PARCEL_GRID, small=SMALL_PARCELS, seed=5, origin=None, cell=None):
    """(polygons, properties): grid^2 star-shaped parcels of 8-64
    vertices on ``cell`` m cells (PARCEL_CELL) from the north-west corner
    ``origin`` (PARCEL_ORIGIN), radii and jitter scaled with the cell from
    20-30 m and 2 m at PARCEL_CELL, then ``small`` parcels of radius 0.3 m
    around 1 m cell corners; properties id, code (1-99) and threshold
    (float, 50-150)."""
    rng = np.random.default_rng(seed)
    x0, y0 = PARCEL_ORIGIN if origin is None else origin
    cell = PARCEL_CELL if cell is None else cell
    scale = cell / PARCEL_CELL
    polygons = []
    for j in range(grid):
        for i in range(grid):
            n = int(rng.integers(8, 65))
            angles = np.sort(rng.uniform(0, 2 * np.pi, n))
            radii = rng.uniform(20.0, 30.0, n) * scale
            cx = x0 + cell * (i + 0.5) + rng.uniform(-2, 2) * scale
            cy = y0 - cell * (j + 0.5) + rng.uniform(-2, 2) * scale
            polygons.append([(float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                             for t, r in zip(angles, radii)])
    for k in range(small):
        cx = x0 + 100.0 + 150.0 * k
        cy = y0 - 100.0 - 120.0 * k
        polygons.append([(cx - 0.3, cy - 0.3), (cx + 0.3, cy - 0.3), (cx + 0.3, cy + 0.3),
                         (cx - 0.3, cy + 0.3)])
    properties = [{"id": k, "code": int(rng.integers(1, 100)),
                   "threshold": float(rng.uniform(50.0, 150.0))} for k in range(len(polygons))]
    return polygons, properties


def zonal_request(grid=PARCEL_GRID, projection="EPSG:28992"):
    """mode "intersects" over the parcels' box, 2000-01-01 to 2000-01-02."""
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.geo.geometry import box

    x0, y0 = PARCEL_ORIGIN
    bbox = (x0, y0 - PARCEL_CELL * grid, x0 + PARCEL_CELL * grid, y0)
    bbox = Extent(bbox, "EPSG:28992").transformed(projection).bbox
    return dict(mode="intersects", geometry=box(*bbox), projection=projection,
                start=datetime(2000, 1, 1), stop=datetime(2000, 1, 2))


def build_zonal_views(raster, grid=PARCEL_GRID, small=SMALL_PARCELS):
    """The zonal half of benchmarks/run.py's temporal+zonal config:
    {name: (view, request)} over the parcels and ``raster``: AggregateRaster
    with mean, median, p90 and max; sum with a 2^22 pixel budget and auto
    coarsening (the cell doubles); AggregateRasterAboveThreshold counting
    cells at or above each parcel's threshold; and the mean requested in
    EPSG:3857."""
    from dask_geomodeling_tpu_torch.geometry import AggregateRaster, AggregateRasterAboveThreshold

    polygons, properties = make_parcels(grid, small)
    parcels = mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    request = zonal_request(grid)
    views = {s: (AggregateRaster(parcels, raster, s), request)
             for s in ("mean", "median", "p90", "max")}
    views["sum"] = (AggregateRaster(parcels, raster, "sum", max_pixels=2**22,
                                    auto_pixel_size=True), request)
    views["count-above"] = (AggregateRasterAboveThreshold(
        parcels, raster, "count", threshold_name="threshold"), request)
    views["mean-3857"] = (views["mean"][0], zonal_request(grid, "EPSG:3857"))
    return views


def wkt_polygon(px, vertices=600, seed=6):
    """A polygon of ``vertices`` vertices with one hole over a px^2 square
    at the source's origin: a star (radius 0.25-0.45 px) around a point
    0.3 px from the west edge, its edges crossing tile borders and the
    request's west edge (so the westmost tiles, which chip_smoke samples,
    hold its boundary), and a 100-vertex hole (radius 0.05-0.1 px) around
    the same point."""
    rng = np.random.default_rng(seed)
    x0, y0 = 135000.0, 456000.0
    cx, cy = x0 + 0.3 * px, y0 - px / 2

    def ring(n, lo, hi):
        angles = np.sort(rng.uniform(0, 2 * np.pi, n))
        radii = rng.uniform(lo, hi, n) * px
        points = ["%r %r" % (float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
                  for t, r in zip(angles, radii)]
        return "(" + ", ".join(points + points[:1]) + ")"

    return "POLYGON (%s, %s)" % (ring(vertices - 100, 0.25, 0.45), ring(100, 0.05, 0.1))


def build_geometry_paths(px=ALGEBRA_PX, rasterize_px=2048, parcels_grid=16):
    """The tiled geometry paths, as build_algebra_paths gives them:

    - rasterize-wkt: Clip(a, RasterizeWKT(polygon, "EPSG:28992")) with
      wkt_polygon (600 vertices, one hole) at px^2.  RasterizeWKT is static
      at 1970-01-01 (its period) and Clip keeps the frames the two share,
      so a is make_source's source with its one frame at 1970-01-01 and
      the request asks for that instant;
    - rasterize: Add(Rasterize(parcels, column_name="code", dtype="int32"), 1)
      over 256 parcels (a 16 x 16 grid) at rasterize_px^2, from the
      parcels' top-left corner: a host node whose per-tile results are
      stacked into the Add twin.
    """
    from dask_geomodeling_tpu_torch.geo import shapely_from_wkt
    from dask_geomodeling_tpu_torch.raster import Add, Clip, Rasterize, RasterizeWKT

    static = datetime(1970, 1, 1)
    a = make_source(px, seed=0, time_first=static)
    request = dict(vals_request(px), start=static, stop=None)
    wkt = wkt_polygon(px)
    hole_x, hole_y = (round(float(c)) for c in shapely_from_wkt(wkt).holes[0][0])
    polygons, properties = make_parcels(parcels_grid, 0)
    parcels = mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    x0, y0 = PARCEL_ORIGIN
    size = PARCEL_CELL * parcels_grid
    rasterize_request = dict(mode="vals", bbox=(x0, y0 - size, x0 + size, y0),
                             projection="EPSG:28992", width=rasterize_px, height=rasterize_px,
                             start=datetime(2000, 1, 1))
    return {
        # the crop is centred on a vertex of the hole: it holds the hole's
        # boundary, data on one side and nodata on the other
        "rasterize-wkt": (Clip(a, RasterizeWKT(wkt, "EPSG:28992")), request, "nearest",
                          (hole_x - 32, hole_y + 32)),
        "rasterize": (Add(Rasterize(parcels, column_name="code", dtype="int32"), 1),
                      rasterize_request, "nearest", (x0, y0)),
    }


#: the file paths: one sheet of the Dutch national elevation model (AHN)
#: at 0.5 m, 5 km x 6.25 km: 10000 x 12500 float32 in EPSG:28992, its NW
#: corner on the sheet grid; above the 64 Mi px windowed-read limit
SHEET_WIDTH, SHEET_HEIGHT = 10000, 12500
SHEET_ORIGIN = (120000.0, 487500.0)
SHEET_CELL = 0.5
SHEET_NODATA = float(np.finfo(np.float32).max)
SHEET_NODATA_SHARE = 0.05
SHEET_BLOCK = 600
# to_file's tiles (35 over the sheet), the reprojected and exported
# sub-area, and the COG's overview factors
EXPORT_TILE = 2048
FILE_SUB_PX = 4096
COG_OVERVIEWS = [2, 4, 8]


def sheet_block_at(width, height):
    """(row, col) of the nodata block's north-west corner: inside the
    sampled tile 465 of a full-size file-read run."""
    return int(height * 0.012), int(width * 0.24)


def write_sheet(folder, width=SHEET_WIDTH, height=SHEET_HEIGHT, block=SHEET_BLOCK, seed=11):
    """Write the synthetic elevation sheet with the port's own writer
    (deflate, 512^2 tiles) to ``folder``/sheet.tif; returns its path.
    Smooth terrain of a few metres plus 1 cm noise from ``seed``, heights
    to the millimetre, nodata (float32's maximum) in SHEET_NODATA_SHARE of
    the cells and in a block^2 square.  Made row band by row band to keep the host's
    transient memory small."""
    from dask_geomodeling_tpu_torch.io.geotiff import write_geotiff

    rng = np.random.default_rng(seed)
    x = np.arange(width) * SHEET_CELL
    y = np.arange(height) * SHEET_CELL
    across = 2.5 * np.sin(x / 270.0)
    slope = 0.0008 * x
    data = np.empty((1, height, width), np.float32)
    for row0 in range(0, height, 1024):
        row1 = min(height, row0 + 1024)
        rows = np.round(1000.0 * (3.0 + across[None, :] * np.cos(y[row0:row1] / 365.0)[:, None]
                                  + slope[None, :] + 0.01 * rng.standard_normal((row1 - row0, width))
                                  )) / 1000.0
        rows[rng.random((row1 - row0, width)) < SHEET_NODATA_SHARE] = SHEET_NODATA
        data[0, row0:row1] = rows
    row, col = sheet_block_at(width, height)
    data[0, row : row + block, col : col + block] = SHEET_NODATA
    path = os.path.join(folder, "sheet.tif")
    write_geotiff(path, data, (SHEET_ORIGIN[0], SHEET_CELL, 0.0, SHEET_ORIGIN[1], 0.0, -SHEET_CELL),
                  "EPSG:28992", SHEET_NODATA, compress="deflate", tiled=True, tile_size=512)
    return path


def sheet_request(source):
    """The whole sheet at its native grid."""
    return dict(mode="vals", bbox=source.geometry.bounds, projection="EPSG:28992",
                width=source.info.width, height=source.info.height)


def sheet_sub_area(request, px, offset=(2048, 4096)):
    """The bbox of a px^2 sub-area of the sheet request: its south-west
    corner ``offset`` (col, row from the bottom) pixels into the sheet, or
    less on a small sheet, on the file-read path's TILE^2 grid."""
    x1, y1, _, _ = request["bbox"]
    col = min(offset[0], (request["width"] - px) // TILE * TILE)
    row = min(offset[1], (request["height"] - px) // TILE * TILE)
    return (x1 + col * SHEET_CELL, y1 + row * SHEET_CELL,
            x1 + (col + px) * SHEET_CELL, y1 + (row + px) * SHEET_CELL)


def build_file_paths(sheet, reproject_px=FILE_SUB_PX):
    """The file paths over the sheet at ``sheet``, as build_algebra_paths
    gives them, both Smooth(RasterFileSource(sheet), 3) (a 6 px margin, sigma 2 px):

    - file-read: the whole sheet at its native grid (500 tiles, read
      window by window), the crop straddling the nodata block's corner;
    - file-reproject: a reproject_px^2 sub-area requested in EPSG:3857
      (its densified extent and cross-CRS windows).
    """
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    source = RasterFileSource(sheet)
    view = Smooth(source, 3)
    request = sheet_request(source)
    x1, _, _, y2 = request["bbox"]
    row, col = sheet_block_at(request["width"], request["height"])
    sub = Extent(sheet_sub_area(request, reproject_px), "EPSG:28992").transformed("EPSG:3857").bbox
    reproject = dict(request, projection="EPSG:3857", bbox=sub, width=reproject_px,
                     height=reproject_px)
    return {
        "file-read": (view, request, "nearest",
                      (x1 + (col - 32) * SHEET_CELL, y2 - (row - 32) * SHEET_CELL)),
        "file-reproject": (view, reproject, "nearest", (sub[0], sub[3])),
    }


#: the zarr-store path: the sheet as an xarray-style Zarr v2 group store
#: of ZARR_CHUNK^2 zlib chunks, its data array ZARR_VARIABLE; to_zarr
#: exports a ZARR_SUB_PX^2 sub-area of the file-read view
ZARR_CHUNK = 512
ZARR_VARIABLE = "elevation"
ZARR_SUB_PX = 2048


def write_sheet_zarr(folder, sheet, chunk=ZARR_CHUNK, name="sheet.zarr"):
    """Write the sheet at ``sheet`` (a GeoTIFF of write_sheet) to
    ``folder``/``name`` as xarray writes a DataArray: a consolidated v2
    group store with the data array ZARR_VARIABLE in chunk^2 zlib chunks
    (level 1, "." keys, edge chunks padded with the fill), 1-D ``x`` and
    ``y`` arrays of cell centres (``y`` descending), ``grid_mapping``
    naming a ``spatial_ref`` array with the CRS's WKT, and ``_FillValue``
    the sheet's nodata.  The chunks compress on a thread pool.  Returns
    (path, bytes written)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from dask_geomodeling_tpu_torch.geo.crs import get_sr
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff

    data = read_geotiff(sheet)
    values = data.array[0]
    height, width = values.shape
    nodata = float(data.no_data_value)
    p, a, _, q, _, d = data.geo_transform
    root = os.path.join(folder, name)

    def meta(shape, chunks, dtype, compressor, fill):
        return {"zarr_format": 2, "shape": list(shape), "chunks": list(chunks), "dtype": dtype,
                "compressor": compressor, "fill_value": fill, "order": "C", "filters": None,
                "dimension_separator": "."}

    coords = {"x": p + a * (np.arange(width) + 0.5), "y": q + d * (np.arange(height) + 0.5)}
    arrays = {
        ZARR_VARIABLE: (meta(values.shape, (chunk, chunk), "<f4", {"id": "zlib", "level": 1},
                             nodata),
                        {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": nodata,
                         "grid_mapping": "spatial_ref", "long_name": "elevation", "units": "m"}),
        "spatial_ref": (meta((), (), "<i4", None, 0),
                        {"_ARRAY_DIMENSIONS": [],
                         "spatial_ref": get_sr(data.projection).ExportToWkt()}),
    }
    for axis, centres in coords.items():
        arrays[axis] = (meta(centres.shape, centres.shape, "<f8", None, None),
                        {"_ARRAY_DIMENSIONS": [axis]})
    metadata = {".zgroup": {"zarr_format": 2}, ".zattrs": {}}
    for array_name, (array_meta, attrs) in arrays.items():
        os.makedirs(os.path.join(root, array_name))
        for key, document in ((".zarray", array_meta), (".zattrs", attrs)):
            metadata[array_name + "/" + key] = document
            with open(os.path.join(root, array_name, key), "w") as f:
                json.dump(document, f)
    for key in (".zgroup", ".zattrs"):
        with open(os.path.join(root, key), "w") as f:
            json.dump(metadata[key], f)
    with open(os.path.join(root, ".zmetadata"), "w") as f:
        json.dump({"metadata": metadata, "zarr_consolidated_format": 1}, f)
    written = [np.zeros((), "<i4").tobytes()]
    with open(os.path.join(root, "spatial_ref", "0"), "wb") as f:
        f.write(written[0])
    for axis, centres in coords.items():
        written.append(centres.astype("<f8").tobytes())
        with open(os.path.join(root, axis, "0"), "wb") as f:
            f.write(written[-1])
    cols = -(-width // chunk)

    def write_chunk(index):
        i, j = divmod(index, cols)
        block = np.full((chunk, chunk), nodata, np.float32)
        part = values[i * chunk : (i + 1) * chunk, j * chunk : (j + 1) * chunk]
        block[: part.shape[0], : part.shape[1]] = part
        payload = zlib.compress(block.tobytes(), 1)
        with open(os.path.join(root, ZARR_VARIABLE, "%d.%d" % (i, j)), "wb") as f:
            f.write(payload)
        return len(payload)

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        chunk_bytes = sum(pool.map(write_chunk, range(-(-height // chunk) * cols)))
    return root, chunk_bytes + sum(len(b) for b in written)


#: the netcdf-radar path: a day of a weather radar's 5-minute rain
#: accumulations over the Netherlands (a composite of 1 km cells in RD New,
#: RADAR_SIZE^2) in a CDF-2 file, as radar archives hand them out; its
#: hourly sums of three hours of an afternoon, smoothed over 3 km, asked at
#: RADAR_PX^2 of 100 m, and under a RADAR_WINDOW_LIMIT windowed-read limit
RADAR_DAY = datetime(2021, 7, 14)
RADAR_RECORDS = 288
RADAR_STEP = timedelta(minutes=5)
RADAR_SIZE = 500
RADAR_CELL = 1000.0
RADAR_ORIGIN = (-110000.0, 700000.0)  # the grid's north-west corner
RADAR_SCALE = 0.01  # mm a packed step
RADAR_FILL = -32767
RADAR_FILL_SHARE = 0.05
RADAR_HOURS = (13, 16)
RADAR_SMOOTH_M = 3000.0
RADAR_PX = 4096
RADAR_REQUEST_CELL = 100.0
RADAR_WINDOW_LIMIT = 100000
RADAR_EXPORT_PX = 1024
#: nc_type -> big-endian numpy dtype, for the hand-built netCDF files
NC_TYPES = {1: ">i1", 2: "S1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8"}


def write_classic_netcdf(path, dims, variables, numrecs, gatts=(), version=2,
                         numrecs_field=None):
    """Write a netCDF classic file by hand, in one buffered write: CDF-1
    (``version`` 1, 32-bit offsets) or CDF-2 (2, 64-bit offsets).  ``dims``
    is [(name, length)], length 0 the UNLIMITED (record) dimension;
    ``variables`` is [(name, dimids, atts, nc_type, values)], a record
    variable's ``values`` holding ``numrecs`` records; ``atts`` and
    ``gatts`` are [(name, value)], a str stored as NC_CHAR and an (nc_type,
    numbers) pair as numbers.  The fixed variables come first, each padded
    to 4 bytes, then the records: each holds every record variable's slab
    padded to 4, or the bare slab where one variable records.
    ``numrecs_field`` replaces the header's record count (0xFFFFFFFF, the
    STREAMING sentinel).  Returns the bytes written."""
    import struct

    def pad(n):
        return -(-n // 4) * 4

    def u4(value):
        return struct.pack(">I", value)

    def name(text):
        raw = text.encode()
        return u4(len(raw)) + raw.ljust(pad(len(raw)), b"\0")

    def att_list(atts):
        if not atts:
            return u4(0) + u4(0)
        blob = u4(0x0C) + u4(len(atts))
        for key, value in atts:
            if isinstance(value, str):
                nc_type, raw, count = 2, value.encode(), len(value.encode())
            else:
                nc_type, numbers = value
                raw = np.asarray(numbers, NC_TYPES[nc_type]).tobytes()
                count = len(raw) // np.dtype(NC_TYPES[nc_type]).itemsize
            blob += name(key) + u4(nc_type) + u4(count) + raw.ljust(pad(len(raw)), b"\0")
        return blob

    record = [bool(dimids) and dims[dimids[0]][1] == 0 for _, dimids, _, _, _ in variables]
    slabs = [int(np.prod([dims[d][1] for d in dimids[int(rec):]])) * np.dtype(
        NC_TYPES[nc_type]).itemsize for (_, dimids, _, nc_type, _), rec in zip(variables, record)]
    n_record = sum(record)

    def header(begins):
        blob = b"CDF" + bytes([version])
        blob += u4(numrecs if numrecs_field is None else numrecs_field)
        blob += u4(0x0A) + u4(len(dims)) + b"".join(name(n) + u4(length) for n, length in dims)
        blob += att_list(list(gatts))
        blob += u4(0x0B) + u4(len(variables))
        for (vname, dimids, atts, nc_type, _), slab, begin in zip(variables, slabs, begins):
            blob += name(vname) + u4(len(dimids)) + b"".join(u4(d) for d in dimids)
            blob += att_list(list(atts)) + u4(nc_type) + u4(pad(slab))
            blob += struct.pack(">Q" if version == 2 else ">I", begin)
        return blob

    offset = len(header([0] * len(variables)))
    begins = [0] * len(variables)
    for k, (slab, rec) in enumerate(zip(slabs, record)):
        if not rec:
            begins[k] = offset
            offset += pad(slab)
    records_at, stride = offset, 0
    for k, (slab, rec) in enumerate(zip(slabs, record)):
        if rec:
            begins[k] = records_at + stride
            stride += pad(slab) if n_record > 1 else slab
    buffer = np.zeros(records_at + numrecs * stride, np.uint8)
    head = header(begins)
    buffer[: len(head)] = np.frombuffer(head, np.uint8)
    if numrecs:
        records = buffer[records_at:].reshape(numrecs, stride)
    for (_, _, _, nc_type, values), slab, rec, begin in zip(variables, slabs, record, begins):
        raw = np.ascontiguousarray(values, NC_TYPES[nc_type])
        if not rec:
            buffer[begin : begin + slab] = raw.reshape(-1).view(np.uint8)
        elif numrecs:
            at = begin - records_at
            records[:, at : at + slab] = raw.reshape(numrecs, -1).view(np.uint8)
    with open(path, "wb") as f:
        f.write(buffer)
    return buffer.size


def radar_frames(records, size, seed):
    """(precipitation, quality): 5-minute rain in RADAR_SCALE mm steps,
    int16, north-up, showers of 25 km cells over a dry 70% of the map with
    small noise, RADAR_FILL in RADAR_FILL_SHARE of the cells; the radar's
    quality index in percent, int8."""
    rng = np.random.default_rng(seed)
    cells = -(-size // 25)
    showers = np.where(rng.random((records, cells, cells)) < 0.7, 0,
                       rng.gamma(0.6, 40.0, (records, cells, cells))).astype(np.int16)
    rain = np.repeat(np.repeat(showers, 25, axis=1), 25, axis=2)[:, :size, :size]
    rain += rng.integers(0, 4, rain.shape, dtype=np.int16)
    rain[rng.random(rain.shape, dtype=np.float32) < RADAR_FILL_SHARE] = RADAR_FILL
    quality = rng.integers(40, 101, rain.shape, dtype=np.int8)
    return rain, quality


def write_radar_netcdf(folder, records=RADAR_RECORDS, size=RADAR_SIZE, seed=21, name="radar.nc"):
    """Write a day of radar frames (radar_frames) to ``folder``/``name`` as
    a CDF-2 file (write_classic_netcdf): ``time`` UNLIMITED with ``records``
    records, ``y`` and ``x`` of ``size`` cells of RADAR_CELL m from
    RADAR_ORIGIN in EPSG:28992; float64 cell centres, ``y`` ascending (the
    rows stored south-up); three record variables interleaving record by
    record: ``time`` (float64, minutes since the first frame),
    ``precipitation`` (NC_SHORT, ``scale_factor`` RADAR_SCALE, ``add_offset``
    0, ``_FillValue`` RADAR_FILL) and ``quality`` (NC_BYTE); both name the
    ``grid_mapping`` ``projection``, a scalar NC_INT whose ``epsg_code`` is
    its only georeferencing.  Returns (path, bytes written)."""
    rain, quality = radar_frames(records, size, seed)
    x0, y_top = RADAR_ORIGIN
    xs = x0 + RADAR_CELL * (np.arange(size) + 0.5)
    ys = y_top - RADAR_CELL * size + RADAR_CELL * (np.arange(size) + 0.5)
    minutes = np.arange(records) * RADAR_STEP.total_seconds() / 60
    mapping = [("grid_mapping", "projection")]
    variables = [
        ("x", [2], [("standard_name", "projection_x_coordinate"), ("units", "m")], 6, xs),
        ("y", [1], [("standard_name", "projection_y_coordinate"), ("units", "m")], 6, ys),
        ("projection", [], [("epsg_code", "EPSG:28992")], 4, np.zeros(1)),
        ("time", [0], [("units", "minutes since %s" % RADAR_DAY.isoformat(" "))], 6, minutes),
        ("precipitation", [0, 1, 2], [
            ("long_name", "precipitation"), ("units", "mm"), ("scale_factor", (5, [RADAR_SCALE])),
            ("add_offset", (5, [0.0])), ("_FillValue", (3, [RADAR_FILL]))] + mapping, 3,
         rain[:, ::-1]),
        ("quality", [0, 1, 2], [("long_name", "quality"), ("units", "percent")] + mapping, 1,
         quality[:, ::-1]),
    ]
    path = os.path.join(folder, name)
    written = write_classic_netcdf(
        path, [("time", 0), ("y", size), ("x", size)], variables, records,
        gatts=[("Conventions", "CF-1.6"), ("title", "synthetic rain radar, 5-minute sums")])
    return path, written


def build_radar_view(path, variable=None):
    """Smooth(TemporalAggregate(RasterFileSource, "1h", sum), RADAR_SMOOTH_M):
    hourly rain sums of the radar file, smoothed over a few km."""
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth, TemporalAggregate

    source = RasterFileSource(path, time_first=RADAR_DAY,
                              time_delta=int(RADAR_STEP.total_seconds() * 1000), variable=variable)
    return Smooth(TemporalAggregate(source, "1h", statistic="sum"), RADAR_SMOOTH_M)


def radar_request(size=RADAR_SIZE, px=RADAR_PX, cell=RADAR_REQUEST_CELL, hours=RADAR_HOURS):
    """px^2 cells of ``cell`` m in EPSG:28992 in the middle of a size^2 radar
    grid, over the frames from ``hours[0]`` of RADAR_DAY up to ``hours[1]``
    (the stop is the last frame's time: the hourly bins are whole)."""
    x0, y_top = RADAR_ORIGIN
    cx, cy = x0 + size * RADAR_CELL / 2, y_top - size * RADAR_CELL / 2
    half = px * cell / 2
    return dict(mode="vals", bbox=(cx - half, cy - half, cx + half, cy + half),
                projection="EPSG:28992", width=px, height=px,
                start=RADAR_DAY + timedelta(hours=hours[0]),
                stop=RADAR_DAY + timedelta(hours=hours[1]) - RADAR_STEP)


#: the hfa-roughness path: a land-use grid in the style of LGN (the Dutch
#: national land-use grid, here at 5 m) over a water board's 40 x 30 km in
#: RD New, an ERDAS Imagine file of 64^2 blocks, most of them ESRI-GRID-RLE
#: compressed, with a PAM raster attribute table giving each class a
#: Manning's n; reclassified to friction and smoothed over 25 m (sigma 5/3
#: px, radius 7)
LGN_WIDTH = 8000
LGN_HEIGHT = 6000
LGN_CELL = 5.0
LGN_ORIGIN = (80000.0, 480000.0)  # the grid's north-west corner, EPSG:28992
LGN_GEO_TRANSFORM = (LGN_ORIGIN[0], LGN_CELL, 0.0, LGN_ORIGIN[1], 0.0, -LGN_CELL)
LGN_PARCEL = (20, 60)  # rows and columns of a typical parcel
LGN_SEA_SHARE = 0.1
LGN_TOWNS = 12
LGN_TOWN_SIDE = 480  # the largest town's side, px
LGN_SMOOTH_M = 25.0
LGN_SAMPLED = 8
#: (code, name, Manning's n in s/m^(1/3)) of the classes drawn, after
#: LGN's legend
LGN_CLASSES = (
    (1, "agrarisch gras", 0.035), (2, "mais", 0.05), (3, "aardappelen", 0.04),
    (4, "bieten", 0.04), (5, "granen", 0.045), (6, "overige landbouwgewassen", 0.04),
    (8, "glastuinbouw", 0.1), (9, "boomgaarden", 0.08), (10, "bloembollen", 0.035),
    (11, "loofbos", 0.12), (12, "naaldbos", 0.12), (16, "zoet water", 0.025),
    (17, "zout water", 0.025), (18, "bebouwing in primair bebouwd gebied", 0.15),
    (19, "bebouwing in secundair bebouwd gebied", 0.12),
    (20, "bos in primair bebouwd gebied", 0.1), (22, "bos in secundair bebouwd gebied", 0.1),
    (23, "gras in primair bebouwd gebied", 0.035), (24, "kale grond in bebouwd gebied", 0.025),
    (25, "hoofdwegen en spoorwegen", 0.02), (26, "bebouwing in buitengebied", 0.15),
    (28, "gras in secundair bebouwd gebied", 0.035), (30, "kwelders", 0.05),
    (31, "open zand in kustgebied", 0.025), (32, "duinen met lage vegetatie", 0.045),
    (33, "duinen met hoge vegetatie", 0.08), (34, "duinheide", 0.05),
    (35, "open stuifzand en/of rivierzand", 0.025), (36, "heide", 0.05),
    (37, "matig vergraste heide", 0.045), (38, "sterk vergraste heide", 0.04),
    (39, "hoogveen", 0.05), (40, "bos in hoogveengebied", 0.1),
    (41, "overige moerasvegetatie", 0.06), (42, "rietvegetatie", 0.07),
    (43, "bos in moerasgebied", 0.1), (45, "natuurgraslanden", 0.04),
    (61, "boomkwekerijen", 0.07), (62, "fruitkwekerijen", 0.07),
)
#: the built-up classes, drawn cell by cell in the towns
LGN_URBAN = (18, 19, 20, 22, 23, 24, 25, 26)
#: classes in the grid that the attribute table leaves out: nodata after
#: the reclassification, as class 0 (the sea) is
LGN_UNLISTED = (61, 62)


def lgn_classes(width=LGN_WIDTH, height=LGN_HEIGHT, seed=23):
    """(height, width) uint8 land-use classes: bands of about LGN_PARCEL[0]
    rows cut into parcels of about LGN_PARCEL[1] columns, each one class
    of LGN_CLASSES but the built-up ones (agrarian grass the most common);
    LGN_TOWNS squares of up to LGN_TOWN_SIDE cells (half the grid's
    shorter side at most) of built-up classes drawn cell by cell, whose
    blocks do not compress; class 0, the
    sea, west of a wavy coastline over about LGN_SEA_SHARE of the grid."""
    rng = np.random.RandomState(seed)
    codes = np.array([c for c, _, _ in LGN_CLASSES if c not in LGN_URBAN], np.uint8)
    weights = np.where(codes == 1, 20.0, 1.0)
    weights /= weights.sum()
    rows, cols = LGN_PARCEL
    grid = np.empty((height, width), np.uint8)
    row = 0
    while row < height:
        band = rng.randint(rows // 2, rows * 3 // 2 + 1)
        widths = rng.randint(cols // 2, cols * 3 // 2 + 1, width // (cols // 2) + 1)
        parcels = rng.choice(codes, len(widths), p=weights)
        grid[row : row + band] = np.repeat(parcels, widths)[:width]
        row += band
    for _ in range(LGN_TOWNS):
        side = min(rng.randint(LGN_TOWN_SIDE // 2, LGN_TOWN_SIDE + 1), min(height, width) // 2)
        r0, c0 = rng.randint(0, height - side + 1), rng.randint(0, width - side + 1)
        grid[r0 : r0 + side, c0 : c0 + side] = rng.choice(
            np.array(LGN_URBAN, np.uint8), (side, side))
    coast = width * LGN_SEA_SHARE * (1 + 0.2 * np.sin(np.arange(height) / (height / 9.0)))
    grid[np.arange(width)[None, :] < coast[:, None]] = 0
    return grid


def lgn_rat(classes):
    """The raster attribute table of LGN_CLASSES but LGN_UNLISTED: VALUE
    (int, minmax), CLASS_NAME (string, name), MANNING (float, generic) and
    COUNT (int, pixelcount, the class's cells in ``classes``)."""
    flat = classes.reshape(-1)
    counts = np.zeros(256, np.int64)
    for start in range(0, flat.size, 1 << 16):  # a slice at a time: bincount copies to intp
        counts += np.bincount(flat[start : start + (1 << 16)], minlength=256)
    return {"fields": [{"name": "VALUE", "type": "int", "usage": "minmax"},
                       {"name": "CLASS_NAME", "type": "string", "usage": "name"},
                       {"name": "MANNING", "type": "float", "usage": "generic"},
                       {"name": "COUNT", "type": "int", "usage": "pixelcount"}],
            "rows": [[code, name, n, int(counts[code])] for code, name, n in LGN_CLASSES
                     if code not in LGN_UNLISTED]}


def rle_blocks(blocks):
    """The ESRI-GRID-RLE form of each row of ``blocks`` (blocks of integer
    values, one a row; GDAL's hfaband.cpp layout): the minimum (int32),
    the number of runs (int32), the offset of the values (uint32) and their
    bit width (one byte), then each run's length in one to four bytes (the
    top two bits of the first count the bytes that follow, big-endian),
    then each run's value less the minimum in the least width of 0, 1, 2,
    4, 8, 16 or 32 bits (sub-byte widths packed from the least significant
    bit, wider ones big-endian).  The runs of all blocks are found at once;
    only the bytes are joined block by block.  Returns a list of bytes."""
    blocks = np.asarray(blocks)
    n, size = blocks.shape
    minimum = blocks.min(axis=1).astype(np.int64)
    change = np.ones((n, size), bool)
    np.not_equal(blocks[:, 1:], blocks[:, :-1], out=change[:, 1:])
    starts = np.flatnonzero(change)  # every block's first cell starts a run
    block = starts // size
    first = np.searchsorted(block, np.arange(n + 1))  # each block's first run
    counts = np.diff(np.append(starts, n * size))
    runs = blocks.ravel()[starts].astype(np.int64) - minimum[block]
    widths = np.array([0, 1, 2, 4, 8, 16, 32])
    n_bits = widths[np.searchsorted(1 << widths, np.maximum.reduceat(runs, first[:-1]),
                                    side="right")]
    extra = (counts >= 1 << 6).astype(np.int64) + (counts >= 1 << 14) + (counts >= 1 << 22)
    run = np.repeat(np.arange(len(counts)), extra + 1)
    ends = np.cumsum(extra + 1)
    nth = np.arange(len(run)) - np.repeat(ends - extra - 1, extra + 1)
    count_bytes = ((counts[run] >> (8 * (extra[run] - nth))) & 0xFF
                   | np.where(nth == 0, extra[run] << 6, 0)).astype(np.uint8)
    ends = np.concatenate(([0], ends))[first]  # each block's first count byte
    payloads = []
    for b in range(n):
        values, bits = runs[first[b] : first[b + 1]], int(n_bits[b])
        if bits == 0:
            packed = b""
        elif bits < 8:
            per_byte = 8 // bits
            padded = np.zeros(-(-len(values) // per_byte) * per_byte, np.int64)
            padded[: len(values)] = values
            packed = (padded.reshape(-1, per_byte) << np.arange(0, 8, bits)).sum(axis=1)
            packed = packed.astype(np.uint8).tobytes()
        else:
            packed = values.astype({8: np.uint8, 16: ">u2", 32: ">u4"}[bits]).tobytes()
        head = count_bytes[ends[b] : ends[b + 1]].tobytes()
        payloads.append(struct.pack("<iiIB", minimum[b], len(values), 13 + len(head), bits)
                        + head + packed)
    return payloads


def splice_rle(path):
    """Rewrite every block of the first layer of the HFA file ``path`` (as
    write_hfa writes it: uncompressed, 8 to 32 bits a pixel) whose
    ESRI-GRID-RLE form (rle_blocks) is shorter into that form, in place:
    the payload at the block's offset, its size at its block info + 6 and
    the compression flag at + 12.  Returns (blocks spliced, blocks)."""
    from dask_geomodeling_tpu_torch.io import hfa

    handle = hfa._HFAFile(path)
    layer = handle.root.find(name="Layer_1")
    dms = layer.find(name="RasterDMS")
    info_ptr, n_blocks = dms.get("blockinfo"), dms.get("numvirtualblocks")
    per_block = dms.get("numobjectsperblock")
    dtype = np.dtype(hfa._PIXEL_DTYPES[layer.get("pixelType")]).newbyteorder("<")
    info_size = handle.dictionary.type_size("Edms_VirtualBlockInfo")
    infos = info_ptr + info_size * np.arange(n_blocks)
    offsets = [struct.unpack_from("<i", handle.raw, base + 2)[0] for base in infos]
    blocks = np.stack([np.frombuffer(handle.raw, dtype, per_block, offset) for offset in offsets])
    raw = bytearray(handle.raw)
    spliced = 0
    for base, offset, payload in zip(infos, offsets, rle_blocks(blocks)):
        if len(payload) < per_block * dtype.itemsize:
            raw[offset : offset + len(payload)] = payload
            struct.pack_into("<iHH", raw, int(base) + 6, len(payload), 1, 1)
            spliced += 1
    with open(path, "wb") as f:
        f.write(raw)
    return spliced, n_blocks


def write_lgn(folder, width=LGN_WIDTH, height=LGN_HEIGHT):
    """Write lgn_classes to ``folder``/lgn.img with the port's write_hfa
    (64^2 blocks, class 0 the Eimg_NonInitializedValue, LGN_CELL m from
    LGN_ORIGIN in EPSG:28992), splice the blocks that compress into
    ESRI-GRID-RLE (splice_rle), and write lgn_rat beside it as a PAM
    sidecar.  Returns (path, classes, (blocks spliced, blocks))."""
    from dask_geomodeling_tpu_torch.io.hfa import write_hfa
    from dask_geomodeling_tpu_torch.io.pam import write_raster_attribute_table

    classes = lgn_classes(width, height)
    path = os.path.join(folder, "lgn.img")
    write_hfa(path, classes[np.newaxis], geo_transform=LGN_GEO_TRANSFORM,
              projection="EPSG:28992", no_data_value=0)
    blocks = splice_rle(path)
    write_raster_attribute_table(path, lgn_rat(classes))
    return path, classes, blocks


def build_lgn_view(path):
    """Smooth(Reclassify(RasterFileSource(path), the RAT's MANNING by
    class, select=True), LGN_SMOOTH_M): the friction map of a 2D flood
    model, smoothed; the RAT is read from the sidecar as the view is
    built."""
    from dask_geomodeling_tpu_torch.io.pam import (
        rat_as_reclassify_data,
        read_raster_attribute_table,
    )
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Reclassify, Smooth

    data = rat_as_reclassify_data(read_raster_attribute_table(path), "MANNING")
    return Smooth(Reclassify(RasterFileSource(path), data, select=True), LGN_SMOOTH_M)


def lgn_request(width=LGN_WIDTH, height=LGN_HEIGHT):
    """The whole grid at its own cells in EPSG:28992."""
    x0, y_top = LGN_ORIGIN
    return dict(mode="vals", bbox=(x0, y_top - height * LGN_CELL, x0 + width * LGN_CELL, y_top),
                projection="EPSG:28992", width=width, height=height)


#: the building-heights path: synthetic BAG-like building footprints
#: ("panden") over the sheet at a Dutch suburban density, 640 a km^2
#: (20,000 over the sheet's 31.25 km^2), one to a grid cell, exported in
#: tiles of 1000 m
BUILDINGS = 20000
BUILDING_TILE = 1000.0
BUILDING_STATUS = ("Pand in gebruik", "Pand in gebruik (niet ingemeten)", "Verbouwing pand")
BUILDING_STATUS_P = (0.93, 0.05, 0.02)


def building_footprint(rng, cx, cy, radius):
    """One footprint around (cx, cy) inside a circle of ``radius``: a
    rectangle or an L-shape of 40-400 m^2 (less where the circle is
    small), aspect up to 1.8, rotated at random, with up to six extra
    vertices on its edges (4-12 vertices, as BAG outlines carry), to the
    millimetre."""
    l_shape = rng.random() < 0.5
    notch = (rng.uniform(0.3, 0.5), rng.uniform(0.3, 0.5)) if l_shape else (0.0, 0.0)
    aspect = rng.uniform(1.0, 1.8)
    # the largest area whose bounding rectangle fits the circle
    fit = (2 * radius) ** 2 * aspect / (1 + aspect**2) * (1 - notch[0] * notch[1])
    area = rng.uniform(min(40.0, 0.5 * fit), min(400.0, fit))
    rect = area / (1 - notch[0] * notch[1])
    w = np.sqrt(rect * aspect)
    h = rect / w
    nw, nh = notch[0] * w, notch[1] * h
    if l_shape:
        ring = [(0, 0), (w, 0), (w, h - nh), (w - nw, h - nh), (w - nw, h), (0, h)]
    else:
        ring = [(0, 0), (w, 0), (w, h), (0, h)]
    for _ in range(rng.integers(0, 12 - len(ring) + 1) if len(ring) < 12 else 0):
        k = int(rng.integers(len(ring)))
        (x0, y0), (x1, y1) = ring[k], ring[(k + 1) % len(ring)]
        t = rng.uniform(0.2, 0.8)
        ring.insert(k + 1, (x0 + t * (x1 - x0), y0 + t * (y1 - y0)))
    pts = np.array(ring) - (w / 2, h / 2)
    angle = rng.uniform(0, np.pi)
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    return np.round(pts @ rot.T + (cx, cy), 3)


def building_frame(bbox, count=BUILDINGS, seed=13):
    """``count`` synthetic building footprints over ``bbox`` (EPSG:28992)
    as a frame: one building to a cell of a near-square grid over the
    bbox, each inside the circle of its cell (none overlap), with a
    16-digit ``identificatie``, an integer ``bouwjaar`` and a ``status``;
    fids 1..count."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, Index
    from dask_geomodeling_tpu_torch.geo.geometry import Polygon

    rng = np.random.default_rng(seed)
    x1, y1, x2, y2 = bbox
    ny = max(1, int(round(np.sqrt(count * (y2 - y1) / (x2 - x1)))))
    nx = -(-count // ny)
    cw, ch = (x2 - x1) / nx, (y2 - y1) / ny
    radius = min(cw, ch) / 2 * 0.95
    polygons = []
    for k in range(count):
        row, col = divmod(k, nx)
        polygons.append(Polygon(building_footprint(
            rng, x1 + (col + 0.5) * cw, y2 - (row + 0.5) * ch, radius)))
    return GeoDataFrame({
        "identificatie": ["0599100000%06d" % (k + 1) for k in range(count)],
        "bouwjaar": rng.integers(1850, 2024, size=count),
        "status": list(rng.choice(BUILDING_STATUS, size=count, p=BUILDING_STATUS_P)),
    }, geometry=polygons, crs="EPSG:28992", index=Index(np.arange(1, count + 1), name="fid"))


def write_buildings(folder, bbox, count=BUILDINGS, seed=13):
    """Write building_frame(bbox, count, seed) into
    ``folder``/buildings.gpkg, layer "pand", with its gpkg_rtree_index.
    Returns the path."""
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    path = os.path.join(folder, "buildings.gpkg")
    write_vector(building_frame(bbox, count, seed), path, layer="pand")
    return path


def build_buildings_view(buildings, sheet, layer="pand", buffer=None):
    """The building-heights view: per building the mean and 90th
    percentile of the smoothed elevation sheet (rounded mean), their
    difference classified into relief classes, and the area.  The
    footprints are the file's ``layer``, buffered by ``buffer`` m if
    given (GPX tracks, at GPX_BUFFER_RESOLUTION)."""
    from dask_geomodeling_tpu_torch.geometry import (
        AggregateRaster,
        Area,
        Buffer,
        Classify,
        GeometryFileSource,
        Round,
    )
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    source = GeometryFileSource(buildings, layer=layer)
    if buffer is not None:
        source = Buffer(source, buffer, "EPSG:28992", GPX_BUFFER_RESOLUTION)
    dem = Smooth(RasterFileSource(sheet), 3)
    mean = AggregateRaster(source, dem, "mean")["agg"]
    p90 = AggregateRaster(source, dem, "p90")["agg"]
    return source.set(
        "h_mean", Round(mean, 2),
        "h_p90", p90,
        "relief", Classify(p90 - mean, [0.25, 1.0], ["flat", "sloped", "steep"]),
        "area", Area(source, "EPSG:28992"),
    )


def fuzz_sources():
    """tests/test_executor_fuzz.py's sources, with the port's MemorySource."""
    from dask_geomodeling_tpu_torch.raster import MemorySource

    rng = np.random.RandomState(7)
    common = dict(projection="EPSG:28992", pixel_size=0.5, pixel_origin=(135000, 456000),
                  time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))
    uint8 = MemorySource(data=(rng.rand(2, 12, 12) * 250).astype(np.uint8),
                         no_data_value=255, **common)
    f32_data = (rng.rand(2, 12, 12) * 100).astype(np.float32)
    f32_data[0, :3, :3] = np.float32(np.finfo(np.float32).max)  # nodata
    f32 = MemorySource(data=f32_data, no_data_value=float(np.finfo(np.float32).max), **common)
    return [uint8, f32]


def random_view(rng, sources, depth):
    """tests/test_executor_fuzz.py:random_view with the port's classes:
    the same tree for the same random state."""
    from dask_geomodeling_tpu_torch import raster as R

    if depth == 0:
        return sources[rng.randint(len(sources))]

    def sub():
        return random_view(rng, sources, depth - 1)

    choice = rng.randint(16)
    const = float(np.round(rng.rand() * 20 + 1, 2))
    if choice == 0:
        return R.Add(sub(), const)
    if choice == 1:
        return R.Multiply(sub(), const)
    if choice == 2:
        return R.Subtract(sub(), const)
    if choice == 3:
        return R.Add(sub(), sub())
    if choice == 4:
        return R.Greater(sub(), const)
    if choice == 5:
        return R.Mask(sub(), value=int(const))
    if choice == 6:
        return R.MaskBelow(sub(), int(const))
    if choice == 7:
        return R.Classify(sub(), bins=[10.0, 50.0, 120.0])
    if choice == 8:
        return R.FillNoData(sub(), sub())
    if choice == 9:
        return R.Step(sub(), left=1, right=2, value=int(const), at=3)
    if choice == 10:
        return R.Reclassify(R.Classify(sub(), bins=[10.0, 50.0, 120.0]), data=[[1, 7.0], [2, 3.5]])
    if choice == 11:
        return R.Power(sub(), 2)
    if choice == 12:
        inner = sub()
        if inner.dtype == np.dtype("bool"):
            return inner  # IsData/IsNoData reject boolean inputs
        return R.IsData(inner) if rng.rand() < 0.5 else R.IsNoData(inner)
    if choice == 13:
        return R.Max(sub(), sub())
    if choice == 14:
        first, second = sub(), sub()
        if np.result_type(first.dtype, second.dtype) == np.dtype(bool):
            first = R.Add(first, 1)  # promotes to an integer raster
        return R.Group(first, second)
    return R.Clip(sub(), R.Greater(sub(), const))


FUZZ_REQUEST = dict(mode="vals", start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 1),
                    width=12, height=12, bbox=(135000, 455994, 135006, 456000),
                    projection="EPSG:28992")


def fuzz_view(seed, sources):
    """The fuzz's tree and request for ``seed`` (seeds from 40 on are its
    tiled ones: shallower, one frame)."""
    rng = np.random.RandomState(seed)
    if seed < 40:
        return random_view(rng, sources, depth=rng.randint(2, 5)), dict(FUZZ_REQUEST)
    view = random_view(rng, sources, depth=rng.randint(2, 4))
    return view, dict(FUZZ_REQUEST, stop=datetime(2000, 1, 1))


def same_as_host(actual, expected):
    """The fuzz's rule: bitwise for integer and boolean values, rtol 1e-6
    for floats; the dtype and no_data_value equal."""
    if expected is None or actual is None:
        return actual is None and expected is None
    a, e = actual["values"], expected["values"]
    if a.dtype != e.dtype or actual["no_data_value"] != expected["no_data_value"]:
        return False
    if e.dtype.kind == "f":
        return bool(np.allclose(a, e, rtol=1e-6, atol=0, equal_nan=True))
    return bool(np.array_equal(a, e))


# --- measurement helpers ---


def check(condition, message):
    if not condition:
        raise RuntimeError("check failed: " + message)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(run):
    """(wall s, device busy ms) of ``run()`` under torch.profiler: the
    summed time of the kernels and copies on the card; busy ms is None
    when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_us = 0.0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            busy_us += getattr(event, "self_device_time_total", None) or getattr(
                event, "self_cuda_time_total", 0.0)
    return wall_s, (busy_us / 1e3 if busy_us > 0 else None)


def bound(bytes_moved, ops, ops_per_s):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take, the larger of the bytes over HBM's rate and the operations over
    their type's peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def card_description():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def smooth_sigma(view, request):
    """(sigma_y, sigma_x) of the Smooth node in ``request``'s plan."""
    graph, _ = view.get_compute_graph(**request)
    for value in graph.values():
        if isinstance(value, tuple) and getattr(value[0], "__name__", "") == "_smooth_process":
            size_y, size_x = value[2]["size"]
            return size_y / 3, size_x / 3
    raise RuntimeError("no Smooth node in the plan")


def tile_window(index, nx, height, tile):
    """(row slice, col slice) of full tile ``index`` in the assembled
    output: tiles run from the south-west corner, rows from the north."""
    j, i = divmod(index, nx)
    row_end = height - j * tile
    return slice(row_end - tile, row_end), slice(i * tile, (i + 1) * tile)


def tile_cells(index, nx, width, height, tile):
    """((row slice, col slice) in the assembled output, (the same in the
    tile)) of tile ``index``'s cells inside the request: an edge tile
    reaches past the request's top and right edges."""
    j, i = divmod(index, nx)
    vw, vh = min(tile, width - i * tile), min(tile, height - j * tile)
    row_end = height - j * tile
    return ((slice(row_end - vh, row_end), slice(i * tile, i * tile + vw)),
            (slice(tile - vh, tile), slice(0, vw)))


def same(a, b):
    """torch.equal, with NaN in the same places counting as equal."""
    import torch

    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def build_kernels():
    """Build both kernel libraries and the host's C++ (the port's native
    TIFF decoders, JPEG and WebP codecs and rasterizer, and
    chip_smoke_encoders.cpp)
    at once (one nvcc or g++ each); prints each build's time and ptxas
    lines."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.ops import _build

    names = ["gaussian_blur", "moving_max"]
    host = {"tiffcodec": native.load_tiffcodec, "jpegcodec": native.load_jpegcodec,
            "webpcodec": native.load_webpcodec, "rasterize": native.load_rasterizer,
            "chip_smoke_encoders": fixture_encoders}
    errors = []

    def build(name):
        try:
            if name in host:
                host[name]()
            else:
                _build.load_library(name)
        except Exception as exc:  # reported below, then raised
            errors.append((name, exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name,)) for name in names + list(host)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise RuntimeError("kernel build failed: %s: %s" % errors[0])
    print("build: %s and %s in %.2f s" % (", ".join(n + ".cu" for n in names),
                                          ", ".join(n + ".cpp" for n in host),
                                          time.perf_counter() - t0))
    for name in host:
        log = _build.build_log[name]
        print("build: %s.cpp g++ %.2f s%s" % (name, log["seconds"],
                                            " (%s)" % log["log"] if not log["seconds"] else ""))
    for name in names:
        log = _build.build_log[name]
        print("build: %s.cu nvcc %.2f s" % (name, log["seconds"]))
        for line in log["log"].splitlines():
            if "Function properties for" in line:
                print("  ptxas: " + kernel_name(line.split()[-1]))
            elif "registers" in line or "spill" in line:
                print("  ptxas:   " + line.replace("ptxas info    :", "").strip())
        print_sass_counts(name)


#: SASS opcodes counted per kernel: conversions, float64 arithmetic, the
#: reciprocal that starts an integer division by a runtime value, shared
#: and global memory traffic, branches and barriers
SASS_COUNTED = ("F2F", "DADD", "DMUL", "DFMA", "I2F", "MUFU", "LDS", "STS", "LDG", "STG",
                "BRA", "BAR")


def kernel_name(mangled):
    """A kernel's mangled name without its namespace: the function and its
    template arguments (f float, d double, a-m the integer types, then any
    integer constant)."""
    import re

    found = re.search(r"\d+((?:blur|moving_max)_\w+?)I(\w*?)E?Ev", mangled)
    if not found:
        return mangled
    args = re.sub(r"L[ib](\d+)E", r",\1", found.group(2))
    return "%s<%s>" % (found.group(1), args)


def print_sass_counts(name):
    """Static SASS opcode counts of each kernel in csrc/<name>.cu's
    library, from cuobjdump where the toolkit has it."""
    import os
    import re
    import shutil

    from dask_geomodeling_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        print("  sass: not measured (no cuobjdump)")
        return
    library = _build.library_path(name)
    proc = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        print("  sass: not measured (cuobjdump exit %d)" % proc.returncode)
        return
    counts = {}
    function = None
    for line in proc.stdout.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            function = found.group(1)
            counts[function] = {"all": 0}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if function and op:
            base = op.group(1).split(".")[0]
            tally = counts[function]
            tally["all"] += 1
            if base in SASS_COUNTED:
                tally[base] = tally.get(base, 0) + 1
    for function, tally in counts.items():
        print("  sass: %s %s" % (kernel_name(function), " ".join(
            "%s=%d" % (op, tally.get(op, 0)) for op in ("all",) + SASS_COUNTED)))


def host_values(view, request):
    from dask_geomodeling_tpu_torch import compute_host

    return compute_host(*view.get_compute_graph(**request))["values"]


# --- phases ---


def check_gaussian(device, headline_sigma, stencils_sigma, file_sigma):
    """Phase 3a; returns the kernel records' numbers at the headline
    path's (64, 516, 516), the stencils path's (64, 524, 524) and the
    file-read path's (64, 524, 524; radius 8)."""
    import torch
    from scipy import ndimage

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference

    rng = np.random.RandomState(0)
    planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 4, TILE + 4) * 250).astype(np.float32)
    ).to(device)
    stencil_planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 12, TILE + 12) * 200).astype(np.float32)
    ).to(device)
    # the file-read path's planes: 512^2 tiles and Smooth's margin of
    # 3 sigma on each side, elevations of a few metres
    margin = int(round(3 * file_sigma[0]))
    file_planes = torch.from_numpy(
        (rng.rand(BATCH, TILE + 2 * margin, TILE + 2 * margin) * 8).astype(np.float32)
    ).to(device)
    max_abs_err = {}
    for label, data, (sy, sx) in [
        ("headline", planes, headline_sigma),
        ("stencils", stencil_planes, stencils_sigma),
        ("file-read", file_planes, file_sigma),
        ("radius 8", planes, (2.0, 2.0)),
        ("radius 40 (zoom mode)", planes, (10.0, 10.0)),
    ]:
        before = (cuda_stencils.launches, cuda_stencils.fused_launches)
        got = cuda_stencils.gaussian_blur(data, sy, sx, 0)
        fused = cuda_stencils.fused_launches - before[1]
        check(cuda_stencils.launches - before[0] == (1 if fused else 2),
              "launch count of the %s check" % label)
        want = gaussian_blur_reference(data, sy, sx, 0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        equal = torch.equal(got, want)
        print("kernel check: gaussian_blur %s sigma=(%.6f, %.6f) shape=%s %s launch "
              "equal=%s max_abs_err=%r" % (label, sy, sx, tuple(data.shape),
                                           "fused" if fused else "two-pass", equal, err))
        check(equal, "gaussian_blur differs from its plain version (%s)" % label)
        max_abs_err[label] = err
    host_plane = planes[0].cpu().numpy()
    scipy_plane = ndimage.gaussian_filter(host_plane, headline_sigma, mode="constant", cval=0)
    kernel_plane = cuda_stencils.gaussian_blur(planes[:1].contiguous(), *headline_sigma, 0)
    check(np.array_equal(kernel_plane[0].cpu().numpy(), scipy_plane),
          "gaussian_blur differs from scipy.ndimage.gaussian_filter")
    print("kernel check: gaussian_blur, one plane bitwise equal to scipy.ndimage.gaussian_filter")
    # the integer frames' entry (float64 storage truncated toward zero):
    # each integer width, fused and two-pass radii, values beyond 2**53
    integer_planes = torch.from_numpy(
        rng.randint(0, 256, size=(BATCH, TILE + 12, TILE + 12)).astype(np.uint8)).to(device)
    for dtype, low, high in [(np.uint8, 0, 255), (np.int8, -128, 127), (np.int16, -30000, 30000),
                             (np.uint16, 0, 65535), (np.int32, -2**31, 2**31 - 1),
                             (np.uint32, 0, 2**32 - 1), (np.int64, -2**62, 2**62),
                             (np.uint64, 0, 2**63)]:
        data = torch.from_numpy(rng.randint(low, high, size=(4, 131, 75), dtype=dtype)).to(device)
        for sy, sx in [(5 / 3, 5 / 3), (0.759, 0.760), (1.5, 0.1), (10.0, 10.0)]:
            before = cuda_stencils.launches
            got = cuda_stencils.gaussian_blur(data, sy, sx, 3)
            want = gaussian_blur_reference(data, sy, sx, 3)
            torch.cuda.synchronize()
            check(cuda_stencils.launches > before and got.dtype == data.dtype and
                  torch.equal(got, want), "gaussian_blur's integer entry differs from its plain "
                  "version (%s, sigma %s)" % (np.dtype(dtype).name, (sy, sx)))
    got = cuda_stencils.gaussian_blur(integer_planes, *stencils_sigma, 0)
    want = gaussian_blur_reference(integer_planes, *stencils_sigma, 0)
    equal = torch.equal(got, want)
    label = "integer storage (uint8)"
    max_abs_err[label] = float((got.double() - want.double()).abs().max())
    print("kernel check: gaussian_blur integer storage (truncated between the passes) on "
          "int8-int64 and uint8-uint64 (4, 131, 75) at radii 3, 7 and 40 and a radius of 0, and "
          "uint8 %s at the stencils path's sigma: equal=%s max_abs_err=%r"
          % (tuple(integer_planes.shape), equal, max_abs_err[label]))
    check(equal, "gaussian_blur's integer entry differs from its plain version (uint8)")
    del got, want
    return [dict(time_gaussian(data, sigma), max_abs_err=max_abs_err[path], path=path)
            for path, data, sigma in [("headline", planes, headline_sigma),
                                      ("stencils", stencil_planes, stencils_sigma),
                                      ("file-read", file_planes, file_sigma),
                                      ("integer storage (uint8)", integer_planes,
                                       stencils_sigma)]]


def time_gaussian(planes, sigma):
    """The kernel, its plain version and the library yardstick on
    ``planes`` (CUDA events), and the bound.  The yardstick is one cuDNN
    convolution with the (2r+1)^2 outer-product weights in full float32
    (not bitwise: it sums in another order; an integer batch is convolved
    as its float32 copy).  The bytes are the input read and the output
    written once in the planes' dtype."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference, gaussian_weights

    (wy, ry), (wx, rx) = gaussian_weights(sigma[0]), gaussian_weights(sigma[1])
    weights = torch.from_numpy(np.outer(wy, wx).astype(np.float32)).to(planes.device)[None, None]
    images = planes[:, None].float()  # an integer batch: its float32 copy
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        library_ms = cuda_ms(lambda: F.conv2d(images, weights, padding=(ry, rx)), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    kernel_ms = cuda_ms(lambda: cuda_stencils.gaussian_blur(planes, *sigma, 0), 20)
    plain_ms = cuda_ms(lambda: gaussian_blur_reference(planes, *sigma, 0), 5)
    n_bytes = 2 * planes.numel() * planes.element_size()
    # per output pixel and pass: one multiply, then an add, a multiply and
    # an add per tap pair, each its own float64 instruction (no FMA)
    ops = planes.numel() * ((1 + 3 * ry) + (1 + 3 * rx))
    bound_ms, bound_by = bound(n_bytes, ops, FP64_OPS_PER_S)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, shape=list(planes.shape), radius=[ry, rx])


def check_moving_max(device):
    """Phase 3b; returns the kernel records' numbers at the stencils
    path's (64, 526, 526) and the temporal-median path's (448, 514, 514):
    64 tiles of 7 bands, a margin of 1, float32 nodata in some cells."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import moving_max_reference

    rng = np.random.RandomState(1)
    shape = (BATCH, TILE + 14, TILE + 14)
    planes = torch.from_numpy((rng.rand(*shape) * 200).astype(np.float32)).to(device)
    small = rng.rand(8, 301, 277) * 120  # in range of every dtype below
    bands = np.empty((BATCH * 7, TILE + 2, TILE + 2), np.float32)
    for plane in bands:
        plane[...] = rng.rand(TILE + 2, TILE + 2) * 200
        plane[rng.rand(TILE + 2, TILE + 2) < NODATA_SHARE] = np.finfo(np.float32).max
    temporal_planes = torch.from_numpy(bands).to(device)
    del bands
    path_planes = {"stencils": planes, "temporal-median": temporal_planes}
    cases = [("path shape, size 3", planes, 3),
             ("temporal-median path shape, size 3", temporal_planes, 3)]
    cases += [("size %d" % size, planes[:8].contiguous(), size) for size in (5, 7, 15)]
    for dtype in (np.float64, np.float16, np.int8, np.int16, np.int32, np.int64,
                  np.uint8, np.uint16, np.uint32, np.uint64):
        for size in (3, 5, 7):
            cases.append(("%s, size %d" % (np.dtype(dtype).name, size),
                          torch.from_numpy(small.astype(dtype)).to(device), size))
    wide = rng.randint(-2**62, 2**62, size=(2, 97, 89), dtype=np.int64)
    cases.append(("int64 beyond float64's range, size 3", torch.from_numpy(wide).to(device), 3))
    cases.append(("uint64 high bit, size 3",
                  torch.from_numpy(wide.view(np.uint64)).to(device), 3))
    cases.append(("bool, size 3", torch.from_numpy(small[:2] > 100).to(device), 3))
    with_nan = planes[:4].clone()
    with_nan[1, 100:103, 200:240] = float("nan")
    with_nan[2, 0, 0] = float("nan")
    cases.append(("a plane holding NaN, size 3", with_nan, 3))
    max_abs_err = {}
    for label, data, size in cases:
        before = cuda_stencils.moving_max_launches
        got = cuda_stencils.moving_max(data, size)
        check(cuda_stencils.moving_max_launches == before + 1, "moving_max launch count (%s)" % label)
        want = moving_max_reference(data, size)
        torch.cuda.synchronize()
        equal = got.dtype == want.dtype and same(got, want)
        for path, path_data in path_planes.items():
            if data is path_data:
                equal = equal and torch.equal(got, want)
                max_abs_err[path] = float((got - want).abs().max())
        print("kernel check: moving_max %s shape=%s dtype=%s equal=%s"
              % (label, tuple(data.shape), data.dtype, equal))
        check(equal, "moving_max differs from its plain version (%s)" % label)
        del got, want
    nan_out = cuda_stencils.moving_max(with_nan, 3)
    check(bool(torch.isnan(nan_out[1, 99:104, 199:241]).all())
          and not bool(torch.isnan(nan_out[0]).any()), "NaN did not spread over its windows")
    return [dict(time_moving_max(data), max_abs_err=max_abs_err[path], path=path)
            for path, data in path_planes.items()]


def time_moving_max(planes):
    """The kernel at size 3, its plain version and the library yardstick
    (max_pool2d, bitwise equal at size 3; it has no CUDA kernel for
    integers, so an int16 batch is pooled as its float32 copy, which holds
    every int16 exactly) on ``planes`` (CUDA events), and the bound: the
    comparisons at the float32 rate, or for integers at the int32 rate."""
    import torch
    import torch.nn.functional as F

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import moving_max_reference

    floating = planes.dtype.is_floating_point
    pooled_planes = planes if floating else planes.float()

    def library():
        return F.max_pool2d(pooled_planes[:, None], kernel_size=3, stride=1, padding=1)[:, 0]

    got = cuda_stencils.moving_max(planes, 3)
    pooled = library()
    torch.cuda.synchronize()
    check(torch.equal(got, pooled.to(planes.dtype)), "moving_max differs from max_pool2d at size 3")
    print("kernel check: moving_max %s size 3 equal to max_pool2d(3, stride 1, padding 1)"
          % (tuple(planes.shape),))
    del got, pooled
    kernel_ms = cuda_ms(lambda: cuda_stencils.moving_max(planes, 3), 20)
    plain_ms = cuda_ms(lambda: moving_max_reference(planes, 3), 5)
    library_ms = cuda_ms(library, 20)
    n_bytes = 2 * planes.numel() * planes.element_size()
    ops = planes.numel() * 8  # a 3x3 window: 8 comparisons per output
    bound_ms, bound_by = bound(n_bytes, ops, FP32_OPS_PER_S if floating else INT32_OPS_PER_S)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, shape=list(planes.shape))


def no_twin_view(source):
    """A view whose root's process has no torch twin.  The class is bound
    at module level, where its import path (graph keys hash it) resolves."""
    from dask_geomodeling_tpu_torch.raster import BaseSingle

    class NoTwin(BaseSingle):
        @staticmethod
        def process(data):
            return data

    globals()["NoTwin"] = NoTwin
    return NoTwin(source)


def check_headline(device, source, view, request):
    """Phase 4; returns (launches, host Mpx/s)."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import NotLowerable, tile_requests

    tiles, nx = tile_requests(request, TILE)
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    first_s = time.perf_counter() - t0
    # batches of tiles whose plans agree (a cross-CRS Smooth's sigma
    # differs between tile rows in its last digits)
    n_batches = tile_runtime.batches_run - before
    launches = {"gaussian_blur": cuda_stencils.launches,
                "gaussian_blur_fused": cuda_stencils.fused_launches,
                "moving_max": cuda_stencils.moving_max_launches}
    values = result["values"]
    print("headline path: evaluate_tiled %s %s in %.2f s (first run), launches %s for %d batches"
          % (values.shape, values.dtype, first_s, launches, n_batches))
    check(launches["gaussian_blur"] == n_batches, "gaussian launches != batches")
    check(launches["gaussian_blur_fused"] == n_batches, "the headline path left the fused launch shape")
    check(values.shape == (1, HEADLINE_PX, HEADLINE_PX), "output shape")
    check(set(np.unique(values).tolist()) <= {0, 1, 2, 3, 4, 255}, "output alphabet")
    check((values != 255).mean() > 0.5, "output is mostly fill")

    cuda_stencils.reset_launches()
    routed = get_data(view, device=device, **request)
    check(cuda_stencils.launches == n_batches, "get_data did not run as tiles")
    check(np.array_equal(routed["values"], values), "get_data differs from evaluate_tiled")
    x1, y1, x2, y2 = request["bbox"]
    sub = dict(request, width=256, height=256, bbox=(
        (x1 + x2) / 2, (y1 + y2) / 2,
        (x1 + x2) / 2 + (x2 - x1) / 40, (y1 + y2) / 2 + (y2 - y1) / 40))
    cuda_stencils.reset_launches()
    sub_port = view.get_data(device=device, **sub)
    check(cuda_stencils.launches == 1, "sub-tile get_data did not launch the kernel")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    print("headline path: get_data (tiled and a 256^2 sub-tile request) ran every node on the card")
    no_twin = no_twin_view(source)
    for label, req in [("sub-tile", sub), ("tiled", request)]:
        try:
            get_data(no_twin, device=device, **req)
        except NotLowerable as exc:
            print("headline path: a node without a twin, %s request: NotLowerable (%s)" % (label, exc))
        else:
            raise RuntimeError("check failed: a node without a twin did not raise (%s)" % label)
    check(executor.host_node_runs == host_runs, "a node ran on the host")

    crop = dict(request, width=64, height=64, bbox=(
        x1, y2 - (y2 - y1) * 64 / HEADLINE_PX, x1 + (x2 - x1) * 64 / HEADLINE_PX, y2))
    check(np.array_equal(values[:, :64, :64], host_values(view, crop)), "64^2 crop differs")
    sub_host = host_values(view, sub)
    sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
    t0 = time.perf_counter()
    host_tiles = [host_values(view, tiles[k]) for k in sampled]
    host_s = time.perf_counter() - t0
    differing = 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, HEADLINE_PX, TILE)
        differing += int(np.count_nonzero(values[:, rows, cols] != host_tile))
    share = differing / (len(sampled) * TILE * TILE)
    sub_share = np.count_nonzero(sub_port["values"] != sub_host) / sub_host.size
    print("headline path: 64^2 crop bitwise equal to compute_host; %d tiles: %d of %d cells "
          "differ (share %r); sub-tile share %r" % (len(sampled), differing,
                                                     len(sampled) * TILE * TILE, share, sub_share))
    check(share <= HEADLINE_SHARE, "differing share above %g" % HEADLINE_SHARE)
    check(sub_share <= HEADLINE_SHARE, "sub-tile differing share above %g" % HEADLINE_SHARE)
    return launches, len(sampled) * TILE * TILE / 1e6 / host_s


class plain_hillshade_division:
    """While installed, HillShade's torch branch divides its gradients by
    the resolution's Python numbers, as it did before device.divide:
    torch's CUDA kernel then multiplies by their reciprocals."""

    def __enter__(self):
        from dask_geomodeling_tpu_torch.raster import spatial

        self.divide = spatial.divide
        spatial.divide = lambda values, divisor: values / divisor
        return self

    def __exit__(self, *exc):
        from dask_geomodeling_tpu_torch.raster import spatial

        spatial.divide = self.divide
        return False


def division_shares(view, requests, hosts, device):
    """The shares of the cells of ``requests`` whose card values differ
    from ``hosts`` (compute_host's values), with HillShade's divisions
    through device.divide and with the plain division (the result cache
    off): (after, before)."""
    import contextlib

    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.config import config

    cells = sum(int(np.asarray(host).size) for host in hosts)
    shares = []
    for plain in (False, True):
        differ = 0
        with config.set({"geomodeling.result-cache-size": 0}), (
                plain_hillshade_division() if plain else contextlib.nullcontext()):
            for request, host in zip(requests, hosts):
                values = get_data(view, device=device, **request)["values"]
                differ += int(np.count_nonzero(np.asarray(values) != np.asarray(host)))
        shares.append(differ / cells)
    return shares[0], shares[1]


def check_stencils(device, view, request):
    """Phase 5; returns (launches, host Mpx/s)."""
    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    tiles, nx = tile_requests(request, TILE)
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    first_s = time.perf_counter() - t0
    # batches of tiles whose plans agree (a cross-CRS Smooth's sigma
    # differs between tile rows in its last digits)
    n_batches = tile_runtime.batches_run - before
    launches = {"gaussian_blur": cuda_stencils.launches,
                "gaussian_blur_fused": cuda_stencils.fused_launches,
                "moving_max": cuda_stencils.moving_max_launches}
    values = result["values"]
    print("stencils path: evaluate_tiled %s %s in %.2f s (first run), launches %s for %d batches"
          % (values.shape, values.dtype, first_s, launches, n_batches))
    check(launches["moving_max"] == n_batches, "moving-max launches != batches")
    check(launches["gaussian_blur"] == n_batches, "gaussian launches != batches")
    check(launches["gaussian_blur_fused"] == n_batches, "the stencils path left the fused launch shape")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    check(values.shape == (1, STENCILS_PX, STENCILS_PX) and values.dtype == np.uint8, "output")
    check(result["no_data_value"] == 256, "no_data_value")
    check(len(np.unique(values)) > 100, "output is not shaded")

    cuda_stencils.reset_launches()
    routed = get_data(view, device=device, **request)
    check(cuda_stencils.moving_max_launches == n_batches, "get_data did not run as tiles")
    check(np.array_equal(routed["values"], values), "get_data differs from evaluate_tiled")
    print("stencils path: get_data ran as %d batches and equals evaluate_tiled" % n_batches)

    x1, y1, x2, y2 = request["bbox"]
    corner = dict(request, width=64, height=64, bbox=(x1, y2 - 64, x1 + 64, y2))
    below = view.store
    cuda_stencils.reset_launches()
    card = get_data(below, device=device, **corner)["values"]
    check(cuda_stencils.moving_max_launches == 1 and cuda_stencils.launches == 1,
          "the 64^2 request did not launch both kernels")
    check(np.array_equal(card, host_values(below, corner)),
          "64^2 corner of Smooth(MovingMax) differs from compute_host")
    shaded = get_data(view, device=device, **corner)["values"]
    corner_diff = np.abs(shaded.astype(int) - host_values(view, corner).astype(int)).max()
    check(corner_diff <= 1, "64^2 corner of the view differs by more than 1")
    check(executor.host_node_runs == host_runs, "a node ran on the host")
    print("stencils path: 64^2 corner below HillShade bitwise equal to compute_host; "
          "the view's corner within %d" % corner_diff)

    sampled = list(range(0, len(tiles), len(tiles) // 16))[:16]
    t0 = time.perf_counter()
    host_tiles = [host_values(view, tiles[k]) for k in sampled]
    host_s = time.perf_counter() - t0
    differing = 0
    worst = 0
    for k, host_tile in zip(sampled, host_tiles):
        rows, cols = tile_window(k, nx, STENCILS_PX, TILE)
        diff = np.abs(values[:, rows, cols].astype(int) - host_tile.astype(int))
        differing += int(np.count_nonzero(diff))
        worst = max(worst, int(diff.max()))
    share = differing / (len(sampled) * TILE * TILE)
    print("stencils path: %d tiles: %d of %d cells differ from compute_host (share %r), "
          "largest difference %d" % (len(sampled), differing, len(sampled) * TILE * TILE,
                                     share, worst))
    check(worst <= 1, "a sampled cell differs by more than 1")
    check(share <= STENCILS_SHARE, "differing share above %g" % STENCILS_SHARE)
    after, before = division_shares(view, [tiles[k] for k in sampled], host_tiles, device)
    print("stencils path: HillShade's off-by-one share on the %d tiles %r with device.divide, "
          "%r with the plain division" % (len(sampled), after, before))
    return launches, len(sampled) * TILE * TILE / 1e6 / host_s


def interpolation_set(interpolation):
    from dask_geomodeling_tpu_torch.config import config

    return config.set({"geomodeling.warp-interpolation": interpolation})


def compare_cells(port, host, no_data_value):
    """(differing cells, largest difference, cells nodata in one and data
    in the other)."""
    differ = port != host
    if port.dtype.kind == "f":
        differ &= ~(np.isnan(port) & np.isnan(host))
    worst = float(np.abs(port[differ].astype(np.float64) - host[differ]).max()) if differ.any() else 0.0
    fill_mismatch = int(np.count_nonzero((port == no_data_value) != (host == no_data_value)))
    return int(np.count_nonzero(differ)), worst, fill_mismatch


def check_algebra_path(label, device, view, request, interpolation, corner, host_nodes=0,
                       share=0.0, sigma_groups=False, sampled_tiles=16, first_run=None,
                       routed=True, gaussian_launches=1):
    """One raster-algebra, temporal, tiled geometry or file path at full
    size; returns (host Mpx/s, the evaluate_tiled values).  Every node that returns pixels runs on the
    card but ``host_nodes`` per tile (Rasterize's, which has no twin): the
    time subrequests of a Group or a temporal block, which return none, run
    on the host while planning; the tiles run in as many batches as a
    MemorySource's would (more where a cross-CRS Smooth's sigma differs
    between tile rows, ``sigma_groups``), the Gaussian launched once per
    batch (``gaussian_launches`` times: twice for a radius above the fused
    launch's limit, a zoom-mode Smooth's); a 64^2 corner and ``sampled_tiles`` tiles are held to compute_host:
    bitwise (at most ``share`` of the cells differing, the headline's rule
    for a cross-CRS nearest warp), or for the cross-CRS bilinear path
    within BILINEAR_ATOL with at most BILINEAR_FILL_SHARE of the cells
    nodata in one and data in the other.  ``first_run``, a (clock,
    phase_seconds dict) pair, times the first run alone: under the clock
    (a PhaseClock), its phases added to the dict.  ``routed`` False skips
    the second whole run, get_data's, held equal to evaluate_tiled."""
    import contextlib

    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import TileProgram, tile_requests

    exact = interpolation == "nearest"
    tiles, nx = tile_requests(request, TILE)
    width, height = request["width"], request["height"]
    with interpolation_set(interpolation):
        program = TileProgram(view, tiles[0], device)
        host_runs = executor.host_node_runs
        batches = tile_runtime.batches_run
        gaussians = cuda_stencils.launches
        clock, phases = first_run or (contextlib.nullcontext(), None)
        t0 = time.perf_counter()
        with clock:
            result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                                    phase_seconds=phases)
        first_s = time.perf_counter() - t0
        batches = tile_runtime.batches_run - batches
        gaussians = cuda_stencils.launches - gaussians
        values = result["values"]
        check(executor.host_node_runs - host_runs == host_nodes * len(tiles),
              "%s: a node ran on the host" % label)
        host_runs = executor.host_node_runs
        check(values.shape[1:] == (height, width), "%s: output shape" % label)
        data_share = float((values != result["no_data_value"]).mean())
        print("%s path: evaluate_tiled %s %s in %.2f s (first run), %d tiles in %d batches; %d "
              "device nodes, %d host nodes; data in %.4f of the cells"
              % (label, values.shape, values.dtype, first_s, len(tiles), batches,
                 program.on_host.count(False), program.on_host.count(True), data_share))
        check(batches == -(-len(tiles) // BATCH) or (sigma_groups and batches <= len(tiles) // 8),
              "%s: tiles split into more batches" % label)
        check(gaussians in (0, gaussian_launches * batches),
              "%s: %d Gaussian launches for %d batches" % (label, gaussians, batches))
        check(data_share > 0.01, "%s: output is all nodata" % label)

        if routed:
            check(np.array_equal(get_data(view, device=device, **request)["values"], values),
                  "%s: get_data differs from evaluate_tiled" % label)
        x1, y1, x2, y2 = request["bbox"]
        cx, cy = corner
        crop = dict(request, width=64, height=64, bbox=(
            cx, cy - (y2 - y1) * 64 / height, cx + (x2 - x1) * 64 / width, cy))
        host_runs = executor.host_node_runs
        card_crop = get_data(view, device=device, **crop)["values"]
        check(executor.host_node_runs - host_runs == host_nodes,
              "%s: a node ran on the host" % label)
        crop_cells = compare_cells(card_crop, host_values(view, crop), result["no_data_value"])

        sampled = list(range(0, len(tiles), len(tiles) // sampled_tiles))[:sampled_tiles]
        t0 = time.perf_counter()
        host_tiles = [host_values(view, tiles[k]) for k in sampled]
        host_s = time.perf_counter() - t0
    differing, worst, fill_mismatch, filled, n_cells = 0, 0.0, 0, 0, 0
    for k, host_tile in zip(sampled, host_tiles):
        (rows, cols), (host_rows, host_cols) = tile_cells(k, nx, width, height, TILE)
        host_tile = host_tile[:, host_rows, host_cols]
        d, w, f = compare_cells(values[:, rows, cols], host_tile, result["no_data_value"])
        differing, worst, fill_mismatch = differing + d, max(worst, w), fill_mismatch + f
        filled += int(np.count_nonzero(host_tile == result["no_data_value"]))
        n_cells += host_tile.size
    print("%s path: 64^2 corner: %d of %d cells differ from compute_host (largest %r, %d "
          "cells nodata on the card); %d tiles: %d of %d cells differ (share %r), largest "
          "difference %r, %d cells nodata in one only, nodata in %r of compute_host's cells"
          % (label, crop_cells[0], card_crop.size, crop_cells[1],
             np.count_nonzero(card_crop == result["no_data_value"]), len(sampled), differing,
             n_cells, differing / n_cells, worst, fill_mismatch, filled / n_cells))
    if exact:
        check(crop_cells[0] <= share * card_crop.size,
              "%s: 64^2 corner differs from compute_host" % label)
        check(differing <= share * n_cells, "%s: sampled tiles differ from compute_host" % label)
    else:
        check(max(worst, crop_cells[1]) <= BILINEAR_ATOL, "%s: difference above %g" % (label, BILINEAR_ATOL))
        check(fill_mismatch / n_cells <= BILINEAR_FILL_SHARE
              and crop_cells[2] / card_crop.size <= BILINEAR_FILL_SHARE,
              "%s: nodata cells differ in more than %g" % (label, BILINEAR_FILL_SHARE))
    # request pixels, all bands of one counted once, as the port's Mpx/s counts them
    return len(sampled) * TILE * TILE / 1e6 / host_s, values


def check_temporal_p90(device, source, request):
    """The 90th percentile over the temporal-median path's source, on a
    64^2 crop, on the card against compute_host: numpy's linear method
    with its _lerp, so bitwise; checked within rtol 1e-6, with the
    differing cells counted."""
    from dask_geomodeling_tpu_torch.raster import TemporalAggregate
    from dask_geomodeling_tpu_torch.runtime import executor

    view = TemporalAggregate(source, "6h", statistic="p90", timezone="Europe/Amsterdam")
    x1, _, _, y2 = request["bbox"]
    crop = dict(request, width=64, height=64, bbox=(x1, y2 - 64, x1 + 64, y2))
    host_runs = executor.host_node_runs
    card = view.get_data(device=device, **crop)["values"]
    check(executor.host_node_runs == host_runs, "p90 crop: a node ran on the host")
    t0 = time.perf_counter()
    host = host_values(view, crop)
    host_s = time.perf_counter() - t0
    check(card.dtype == host.dtype and card.shape == host.shape, "p90 crop: dtype or shape")
    differing = int(np.count_nonzero(card != host))
    print("temporal p90: 64^2 crop %s %s on the card, %d of %d cells differ from compute_host "
          "(largest relative %r; host %.2f s)" % (
              card.shape, card.dtype, differing, card.size,
              float(np.max(np.abs(card.astype(np.float64) - host) / np.maximum(np.abs(host), 1e-30))),
              host_s))
    check(np.allclose(card, host, rtol=1e-6, atol=0), "p90 crop beyond rtol 1e-6")
    return differing


def agg_matrix(frame, column="agg"):
    """A frame's aggregate column as a (features, frames) float64 array
    (multiband cells are one list each)."""
    cells = frame[column].tolist()
    return np.array([np.asarray(c[0] if isinstance(c, list) else [c], np.float64)
                     for c in cells]).reshape(len(cells), -1)


#: zonal statistics held bitwise to compute_host; sum and mean accumulate
#: in float64 with atomics on the card, so they stay within one float32
#: ulp of the host's sequential sums after the rounding to float32
ZONAL_EXACT = ("median", "p90", "max", "count-above")
#: the side in parcel cells of the sub-area over which each request is
#: held to compute_host (16 cells took 1.8-8.9 s of host a request on an
#: NVIDIA H100 80GB HBM3 machine, 8 cells 1.2-7.4 s; the mean's whole
#: request 11-14 s, its label planes are held to the host scanline whole).
#: MockGeometry ignores the bbox, so each sub-area request reads the
#: raster over every parcel: zonal_host_truths computes that read once
ZONAL_SUB_CELLS = 8


def compare_zonal(name, port, host, column="agg"):
    """(cells differing, cells beyond one float32 ulp, cells): the port's
    features against compute_host's, index and columns equal, the
    statistic in ``column``."""
    p, h = port["features"], host["features"]
    check(len(p) == len(h) and np.array_equal(p.index.values, h.index.values),
          "zonal %s: features differ" % name)
    check(sorted(p.columns) == sorted(h.columns), "zonal %s: columns differ" % name)
    a, b = agg_matrix(p, column), agg_matrix(h, column)
    differ = ~((a == b) | (np.isnan(a) & np.isnan(b)))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    beyond = differ & ~(np.abs(a - b) <= ulp)
    return int(differ.sum()), int(beyond.sum()), a.size


def _keep_on_device(data):
    """A node that takes its input as the device tensor it is and hands
    it to check_zonal (compute_torch drops the batch axis)."""
    _kept.append(data)
    return None


_keep_on_device.torch_accepts_device_tensors = True
_kept = []


def zonal_phases(view, request, device):
    """One zonal request split into its phases (synchronised): the host
    planning and features, the raster run on the card, the host work of
    the features (to_crs, bucketize), the label planes and the
    statistics; returns (seconds per phase, label planes, covered, grid
    shape, features, groups)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host, compute_torch
    from dask_geomodeling_tpu_torch.geo import parse_percentile_statistic
    from dask_geomodeling_tpu_torch.geometry.aggregate import _device_labels, bucketize
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    seconds = {}
    t0 = time.perf_counter()

    def lap(phase):
        nonlocal t0
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - t0
        t0 = now

    graph, name = view.get_compute_graph(**request)
    _, source_key, raster_key, plan = graph[name]
    features = compute_host(graph, source_key)["features"]
    lap("host planning and features")
    graph = dict(graph, kept=(_keep_on_device, raster_key))
    _kept.clear()
    compute_torch(graph, "kept", device=device)
    raster = _kept.pop()
    values = raster["values"]
    lap("raster run")
    geometry = features.geometry
    geometry.crs = plan["req_srs"]
    agg_geometries = geometry.to_crs(plan["agg_srs"])
    groups = bucketize(agg_geometries.bounds.values)
    lap("host work (to_crs, bucketize)")
    depth, height, width = values.shape
    fill = int(np.iinfo(np.int32).max)
    labels = _device_labels(agg_geometries, groups, plan["agg_bbox"], plan["agg_srs"],
                            height, width, fill, values.device)
    lap("label rasterization")
    statistic, percentile = parse_percentile_statistic(plan["statistic"])
    q = 50.0 if statistic == "median" or percentile is None else float(percentile)
    _, covered = labeled_statistics(values, labels, fill, raster["no_data_value"], None,
                                    len(agg_geometries), statistic, q)
    lap("statistics")
    return seconds, labels, covered.cpu().numpy(), values.shape, agg_geometries, groups, plan, raster


def time_zonal_plane(labels, raster, geometries, groups, plan):
    """CUDA-event ms of the zonal device plane at the path's shapes: the
    label planes from the groups' edges, and the statistics of mean,
    median and p90 over them."""
    from dask_geomodeling_tpu_torch.geometry.aggregate import _device_labels
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    values, nodata = raster["values"], raster["no_data_value"]
    _, height, width = values.shape
    fill = int(np.iinfo(np.int32).max)
    n = len(geometries)
    plane_ms = {"label planes": cuda_ms(lambda: _device_labels(
        geometries, groups, plan["agg_bbox"], plan["agg_srs"], height, width, fill,
        values.device), 3)}
    for name, statistic, q in [("mean", "mean", 50.0), ("median", "median", 50.0),
                               ("p90", "percentile", 90.0)]:
        plane_ms["statistics " + name] = cuda_ms(lambda: labeled_statistics(
            values, labels, fill, nodata, None, n, statistic, q), 5)
    return plane_ms


def time_rasterize_wkt(device, view, request):
    """CUDA-event ms of RasterizeWKT's twin over the first batch of the
    rasterize-wkt path's tiles (the Clip's second source)."""
    import torch

    from dask_geomodeling_tpu_torch.raster.misc import _rasterize_wkt_torch
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    wkt_view = view.args[1]
    tiles, _ = tile_requests(request, TILE)
    bbox = torch.tensor([t["bbox"] for t in tiles[:BATCH]], dtype=torch.float64, device=device)
    data = {"wkt": wkt_view.wkt, "projection": wkt_view.projection}
    return cuda_ms(lambda: _rasterize_wkt_torch(data, dict(tiles[0], bbox=bbox)), 5)


def zonal_host_truths(requests):
    """compute_host's answers to ``requests``, {name: (view, request)},
    from one compute graph: get_compute_graph keys a node by its block's
    token and its request, so a node that several requests share (the
    parcels' features, the raster read of one grid) is computed once.
    Returns ({name: answer}, the graph's nodes)."""
    from dask_geomodeling_tpu_torch import compute_host

    graph, keys = {}, {}
    for name, (view, request) in requests.items():
        graph, keys[name] = view.get_compute_graph(cached_compute_graph=graph, **request)
    nodes = len(graph)
    graph["zonal-host-truths"] = (lambda *answers: answers,) + tuple(keys.values())
    return dict(zip(keys, compute_host(graph, "zonal-host-truths"))), nodes


def check_zonal(device, card, raster):
    """The zonal phase: build_zonal_views over ``raster`` on the card,
    each request against compute_host over a sub-area of ZONAL_SUB_CELLS^2
    parcel cells (count, max, median and p90 bitwise, sum and mean within
    one float32 ulp), the label planes of the whole mean request bitwise
    to the host scanline's and its covered set equal; seconds per request, the phases of one run, the device's busy
    time and idle share and the peak memory.  Returns the numbers."""
    import torch

    from dask_geomodeling_tpu_torch.geo import rasterize_geoseries
    from dask_geomodeling_tpu_torch.runtime import executor

    views = build_zonal_views(raster)
    numbers = {}
    host_runs = executor.host_node_runs
    for name, (view, request) in views.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        features = view.get_data(device=device, **request)["features"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        numbers[name] = dict(first_s=seconds, peak_gib=peak)
        print("zonal %s: %d features on the card in %.3f s (first run), peak memory %.3f GiB"
              % (name, len(features), seconds, peak))
    check(executor.host_node_runs == host_runs, "zonal: a node returning pixels ran on the host")

    # the phases, the label planes and the covered set of the mean request
    view, request = views["mean"]
    phases, labels, covered, shape, geometries, groups, plan, raster = zonal_phases(
        view, request, device)
    depth, height, width = shape
    t0 = time.perf_counter()
    host_covered = np.zeros(len(geometries), bool)
    differing_labels = 0
    for plane, group in enumerate(groups):
        burned = rasterize_geoseries(geometries.iloc[group], plan["agg_bbox"], plan["agg_srs"],
                                     height, width, values=np.asarray(group, dtype=np.int32))
        host_labels = burned["values"][0]
        differing_labels += int(np.count_nonzero(labels[plane].cpu().numpy() != host_labels))
        host_covered[np.unique(host_labels[host_labels != burned["no_data_value"]])] = True
    label_host_s = time.perf_counter() - t0
    print("zonal mean: grid %dx%d x %d frames (%.3f Mpx), %d groups; label planes: %d cells "
          "differ from the host scanline's (host %.2f s); covered %d of %d features, "
          "uncovered sets equal: %s"
          % (width, height, depth, width * height / 1e6, len(groups), differing_labels,
             label_host_s, int(covered.sum()), len(covered),
             bool(np.array_equal(covered, host_covered))))
    check(differing_labels == 0, "zonal: label planes differ from the host scanline's")
    check(np.array_equal(covered, host_covered), "zonal: covered sets differ")
    print("zonal mean: phases of one run (synchronised): %s"
          % ", ".join("%s %.4f s" % kv for kv in phases.items()))
    plane_ms = time_zonal_plane(labels, raster, geometries, groups, plan)
    print("timing [%s] zonal device plane (CUDA events, %d planes of %dx%d, %d frames): %s"
          % (card, len(groups), width, height, depth,
             ", ".join("%s %.4f ms" % kv for kv in plane_ms.items())))
    del raster, labels

    # against compute_host over a sub-area (top left), every request's
    # truth from one graph
    sub = {name: (views[name][0], zonal_request(ZONAL_SUB_CELLS, views[name][1]["projection"]))
           for name in ["mean", "median", "p90", "max", "sum", "count-above", "mean-3857"]}
    t0 = time.perf_counter()
    hosts, host_nodes = zonal_host_truths(sub)
    host_s = time.perf_counter() - t0
    print("zonal: compute_host of the %d sub-area requests from one graph of %d nodes in %.2f s"
          % (len(sub), host_nodes, host_s))
    for name, (view, request) in sub.items():
        port_result = view.get_data(device=device, **request)
        differing, beyond, cells = compare_zonal(name, port_result, hosts[name])
        exact = name in ZONAL_EXACT
        print("zonal %s: sub-area of %d x %d cells, %d features x frames: %d differ from "
              "compute_host, %d beyond one float32 ulp (%s)"
              % (name, ZONAL_SUB_CELLS, ZONAL_SUB_CELLS, cells, differing, beyond,
                 "bitwise" if exact else "within one float32 ulp"))
        check(beyond == 0 and (differing == 0 or not exact),
              "zonal %s differs from compute_host" % name)
    del hosts

    # timing: median of 3 runs of mean and median, device busy time
    for name in ("mean", "median"):
        view, request = views[name]
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            view.get_data(device=device, **request)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        median_s = sorted(runs)[1]
        profiled_s, busy_ms = device_busy_ms(lambda: view.get_data(device=device, **request))
        idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
        rate = width * height * depth / 1e6 / median_s
        numbers[name].update(runs_s=runs, s_per_request=median_s, mpx_frames_per_s=rate,
                             device_busy_ms=busy_ms, idle_share=idle)
        print("timing [%s] zonal %s: %.4f s per request (median of 3: %s), %.3f Mpx x frames/s; "
              "profiled run %.4f s, device busy %s, idle share %s"
              % (card, name, median_s, ", ".join("%.4f" % r for r in runs), rate,
                 profiled_s, "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
                 "not measured" if idle is None else "%.4f" % idle))
    numbers["phases_s"] = phases
    numbers["sub_area_host_s"] = host_s
    numbers["device_plane_ms"] = plane_ms
    numbers["grid"] = [width, height, depth]
    return numbers


def border_band(length, tile, export_tile, reach):
    """Cells of one axis (counted from the request's south-west corner)
    within ``reach`` of a ``tile`` border that is not an ``export_tile``
    border: where a Smooth tile of one grid sees the constant fill past its
    margin and a tile of the other sees data."""
    band = np.zeros(length, bool)
    for edge in range(tile, length, tile):
        if edge % export_tile:
            band[max(0, edge - reach) : edge + reach] = True
    return band


def check_file_export(card, device, view, request, folder, read_values):
    """The file-export phase: to_file of the file-read view over the whole
    sheet in EXPORT_TILE tiles, its mosaic read back, two tile files
    against compute_host, and to_cog of a FILE_SUB_PX^2 sub-area read at
    overview level 2; returns the numbers."""
    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff, read_geotiff_overviews
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_weights
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, RasterTiler, to_cog
    from dask_geomodeling_tpu_torch.runtime import executor
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime

    width, height = request["width"], request["height"]
    x1, y1, _, y2 = request["bbox"]
    target = os.path.join(folder, "export", "out.vrt")
    tiles_dir = os.path.join(folder, "export", "tiles")
    subrequests = [r for _, _, r in RasterTiler(view, EXPORT_TILE)._plan_tiles(request)]
    host_runs = executor.host_node_runs
    cuda_stencils.reset_launches()
    # one profiled run: the profiler's cost is small beside the export's
    # host work (35 subrequests, a few kernels each)
    export_s, busy_ms = device_busy_ms(
        lambda: view.to_file(target, tile_size=EXPORT_TILE, device=device))
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / export_s
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    names = sorted(os.listdir(tiles_dir))
    print("file-export: to_file %dx%d in %d^2 tiles (%d subrequests through compute_torch, no "
          "tile batches): %d files, %d Gaussian launches, %.3f s, %.3f Mpx/s, device busy %s, "
          "idle share %s [%s]" % (
              width, height, EXPORT_TILE, len(subrequests), len(names), launches["gaussian_blur"],
              export_s, width * height / 1e6 / export_s,
              "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
              "not measured" if idle is None else "%.4f" % idle, card))
    check(len(names) == len(subrequests), "file-export: one file per subrequest")
    check(launches["gaussian_blur"] == len(subrequests),
          "file-export: one Gaussian launch per subrequest")
    check(executor.host_node_runs == host_runs, "file-export: a node returning pixels ran on "
          "the host")  # the sinks return None

    # the mosaic, read back window by window through RasterFileSource
    mosaic_source = RasterFileSource(target)
    check(mosaic_source._file_read_plan(request) is not None, "file-export: the VRT read is "
          "not windowed")
    before = tile_runtime.batches_run
    t0 = time.perf_counter()
    mosaic = get_data(mosaic_source, device=device, **request)["values"]
    read_s = time.perf_counter() - t0
    batches = tile_runtime.batches_run - before
    n_tiles = len(tile_runtime.tile_requests(request, TILE)[0])
    check(batches == -(-n_tiles // BATCH), "file-export: the mosaic read ran %d batches" % batches)
    written = np.full_like(mosaic, SHEET_NODATA)
    for name in names:
        data = read_geotiff(os.path.join(tiles_dir, name))
        col = int(round((data.geo_transform[0] - x1) / SHEET_CELL))
        row = int(round((y2 - data.geo_transform[3]) / SHEET_CELL))
        written[:, row : row + data.array.shape[1], col : col + data.array.shape[2]] = data.array
    check(np.array_equal(mosaic, written), "file-export: the mosaic differs from its files")
    # against the file-read run: equal but where a 512^2 tile of that run
    # saw the constant fill past Smooth's margin and a 2048^2 one data
    sigma = smooth_sigma(view, tile_runtime.tile_requests(request, TILE)[0][0])[0]
    reach = max(0, gaussian_weights(sigma)[1] - int(round(3 * sigma)))
    band = (border_band(height, TILE, EXPORT_TILE, reach)[::-1][:, None]
            | border_band(width, TILE, EXPORT_TILE, reach)[None, :])
    differ = mosaic[0] != read_values[0]
    print("file-export: mosaic read back in %d batches, %.3f s, equal to the written files; "
          "against file-read: %d cells differ, all within %d px of a 512^2 tile border "
          "(%d cells there): %s" % (batches, read_s, int(differ.sum()), reach, int(band.sum()),
                                    not (differ & ~band).any()))
    check(not (differ & ~band).any(), "file-export: the mosaic differs from file-read away "
          "from the tile borders")
    host_s, host_px = 0.0, 0
    for sub in (subrequests[0], subrequests[len(subrequests) // 2]):
        data = read_geotiff(os.path.join(tiles_dir, tokenize(sub)[:7] + ".tif"))
        t0 = time.perf_counter()
        host = host_values(view, sub)
        host_s += time.perf_counter() - t0
        host_px += host.size
        check(np.array_equal(data.array, host), "file-export: a tile file differs from "
              "compute_host")
    print("file-export: two tile files bitwise equal to compute_host of their subrequests "
          "(numpy host %.3f Mpx/s) [%s]" % (host_px / 1e6 / host_s, card))

    # to_cog of a sub-area on the file-read tile grid, read at overview level 2
    sub = sheet_sub_area(request, FILE_SUB_PX)
    cog = os.path.join(folder, "sub.cog.tif")
    cuda_stencils.reset_launches()
    t0 = time.perf_counter()
    to_cog(view, cog, overviews=COG_OVERVIEWS, bbox=sub, width=FILE_SUB_PX, height=FILE_SUB_PX,
           projection="EPSG:28992", device=device)
    cog_s = time.perf_counter() - t0
    launches["gaussian_blur"] += cuda_stencils.launches
    row = int(round((y2 - sub[3]) / SHEET_CELL))
    col = int(round((sub[0] - x1) / SHEET_CELL))
    check(np.array_equal(read_geotiff(cog).array, read_values[:, row : row + FILE_SUB_PX,
                                                              col : col + FILE_SUB_PX]),
          "file-export: the COG differs from file-read")
    check(read_geotiff_overviews(cog) == [(FILE_SUB_PX // f, FILE_SUB_PX // f)
                                          for f in COG_OVERVIEWS], "file-export: COG overviews")
    coarse = dict(mode="vals", bbox=sub, projection="EPSG:28992", width=FILE_SUB_PX // 4,
                  height=FILE_SUB_PX // 4)
    cog_source = RasterFileSource(cog)
    with config.set({"geomodeling.use-overviews": True}):
        level = cog_source._file_read_plan(coarse)[0]
        card_coarse = cog_source.get_data(device=device, **coarse)["values"]
        check(level == 2 and np.array_equal(card_coarse, host_values(cog_source, coarse)),
              "file-export: the overview read")
    print("file-export: to_cog %d^2 with overviews %s in %.3f s (%.3f Mpx/s) [%s], level 0 "
          "bitwise equal to file-read; a %d^2 request read overview level %d, bitwise equal to "
          "compute_host" % (FILE_SUB_PX, COG_OVERVIEWS, cog_s, FILE_SUB_PX**2 / 1e6 / cog_s, card,
                            FILE_SUB_PX // 4, level))
    return launches, dict(export_s=export_s, export_mpx_per_s=width * height / 1e6 / export_s,
                          device_busy_ms=busy_ms, idle_share=idle,
                          host_mpx_per_s=host_px / 1e6 / host_s, files=len(names),
                          mosaic_read_s=read_s, mosaic_batches=batches, cog_s=cog_s,
                          border_cells_differing=int(differ.sum()))


def zarr_clock():
    """A PhaseClock over a Zarr store's window reads: the store stamp's
    walk, the store's metadata, the coordinate arrays, the chunk reads
    (file reads, inflate on the codec's pool, copy; the coordinate
    arrays' reads too), the window reads in all (the cache's misses), the
    window lookups (its hits too), and any whole-store read."""
    from dask_geomodeling_tpu_torch.io import zarr as zarr_io
    from dask_geomodeling_tpu_torch.runtime import pipeline

    return PhaseClock([(pipeline, "_zarr_stamp", "stamp"), (zarr_io, "_open_store", "store open"),
                       (zarr_io, "_grid_centers", "coordinates"),
                       (zarr_io, "_read_array", "chunk reads"),
                       (zarr_io, "read_zarr_window", "window reads"),
                       (pipeline, "read_geotiff_window_cached", "window lookups"),
                       (zarr_io, "read_zarr", "whole reads")])


def check_zarr_store(card, device, folder, sheet, file_read, read_values, sub_px=ZARR_SUB_PX,
                     sampled_tiles=8):
    """The zarr-store phase: (a) the sheet written as a chunked group store
    (write_sheet_zarr); (b) zarr-read, file-read's view and request over
    the store with the checks of check_algebra_path (bitwise), every cell
    equal to file-read's ``read_values``, every tile read by window (no
    whole-store read, no whole-read cache entry) and ``info`` decoding no
    data chunk; (c) to_zarr of a sub_px^2 sub-area of the file-read view on
    the card, read back whole through RasterFileSource equal to the card's
    answer and to file-read's, its CRS EPSG:28992; (d) a chunk rewritten
    in place: a window read cached before gives the new values.  Returns
    (launches, numbers); removes the stores."""
    import zlib

    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.io import zarr as zarr_io
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth, to_zarr
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    file_view, request, interpolation, corner = file_read
    t0 = time.perf_counter()
    store, store_bytes = write_sheet_zarr(folder, sheet)
    write_s = time.perf_counter() - t0
    print("zarr-store: the sheet written as %s (%d^2 zlib chunks, consolidated) in %.2f s, "
          "%.1f MB [%s]" % (os.path.basename(store), ZARR_CHUNK, write_s, store_bytes / 1e6, card))
    cuda_stencils.reset_launches()

    # (b) the header from the metadata and the coordinate arrays alone
    source = RasterFileSource(store)
    decoded = []
    read_array = zarr_io._read_array
    zarr_io._read_array = lambda path, *a, **k: decoded.append(path) or read_array(path, *a, **k)
    try:
        t0 = time.perf_counter()
        info = source.info
        info_s = time.perf_counter() - t0
    finally:
        zarr_io._read_array = read_array
    check(sorted(os.path.basename(path) for path in decoded) == ["x", "y"],
          "zarr-store: info read %s" % decoded)
    check(source.projection == "EPSG:28992" and tuple(source.geo_transform)
          == tuple(file_view.store.geo_transform) and (info.width, info.height)
          == (request["width"], request["height"]), "zarr-store: the store's grid")
    check(source._file_read_plan(request) is not None, "zarr-store: the read is not windowed")
    view = Smooth(source, 3)
    clock, phases = zarr_clock(), {}
    host_rate, values = check_algebra_path("zarr-read", device, view, request, interpolation,
                                           corner, share=0.0, sampled_tiles=sampled_tiles,
                                           first_run=(clock, phases), routed=False)
    read_launches = cuda_stencils.launches
    check(read_launches > 0, "zarr-read: the Gaussian did not launch")
    n_tiles = len(tile_requests(request, TILE)[0])
    # the program's first tile plans twice: n_tiles + 1 lookups
    check(clock.calls["window lookups"] == n_tiles + 1 and clock.calls["whole reads"] == 0
          and not any(key[0] == store for key in pipeline._READ_CACHE),
          "zarr-read: %d window lookups and %d whole reads for %d tiles"
          % (clock.calls["window lookups"], clock.calls["whole reads"], n_tiles))
    differ = int(np.count_nonzero(values != read_values))
    check(differ == 0, "zarr-read: %d cells differ from file-read" % differ)
    del values
    plan_split = dict(clock.seconds)
    plan = ", ".join("%s %.4f s" % (name, seconds) for name, seconds in plan_split.items()
                     if name != "whole reads")
    print("zarr-read: info in %.4f s from the metadata and the coordinates (no data chunk); "
          "every cell equal to file-read's; %d tiles, %d window reads, none whole; first run "
          "%s; within plan: %s [%s]" % (info_s, n_tiles, clock.calls["window reads"], ", ".join(
              "%s %.4f s" % kv for kv in phases.items()), plan, card))

    # (c) to_zarr of a sub-area, read back whole
    sub = sheet_sub_area(request, sub_px)
    sub_request = dict(mode="vals", bbox=sub, projection="EPSG:28992", width=sub_px,
                       height=sub_px)
    target = os.path.join(folder, "sub.zarr")
    t0 = time.perf_counter()
    to_zarr(file_view, target, device=device, **sub_request)
    export_s = time.perf_counter() - t0
    back = RasterFileSource(target)
    check(back.projection == "EPSG:28992", "to_zarr: the store's CRS reads %r"
          % back.projection[:60])
    limit = config.get("geomodeling.windowed-read-limit")
    check((back._file_read_plan(sub_request) is None) == (sub_px**2 <= limit),
          "to_zarr: the read back is not as windowed-read-limit says")
    t0 = time.perf_counter()
    read_back = get_data(back, device=device, **sub_request)["values"]
    read_back_s = time.perf_counter() - t0
    card_answer = get_data(file_view, device=device, **sub_request)["values"]
    x1, _, _, y2 = request["bbox"]
    row = int(round((y2 - sub[3]) / SHEET_CELL))
    col = int(round((sub[0] - x1) / SHEET_CELL))
    check(np.array_equal(read_back, card_answer), "to_zarr: the store differs from the card's "
          "answer")
    check(np.array_equal(read_back, read_values[:, row : row + sub_px, col : col + sub_px]),
          "to_zarr: the store differs from file-read")
    print("to_zarr: %d^2 of the file-read view exported in %.3f s (%.3f Mpx/s), read back whole "
          "in %.3f s, equal to the card's answer and to file-read's, CRS EPSG:28992 [%s]"
          % (sub_px, export_s, sub_px**2 / 1e6 / export_s, read_back_s, card))
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}

    # (d) the store stamp: a chunk rewritten in place is seen
    i, j = 1, 1
    side = ZARR_CHUNK * SHEET_CELL
    chunk_request = dict(mode="vals", projection="EPSG:28992", width=ZARR_CHUNK,
                         height=ZARR_CHUNK, bbox=(x1 + j * side, y2 - (i + 1) * side,
                                                  x1 + (j + 1) * side, y2 - i * side))
    before = get_data(source, device=device, **chunk_request)["values"]
    with zarr_clock() as clock:
        calls = clock.calls["window reads"]
        check(np.array_equal(get_data(source, device=device, **chunk_request)["values"], before)
              and clock.calls["window reads"] == calls, "zarr-store: the window was not cached")
        chunk_path = os.path.join(store, ZARR_VARIABLE, "%d.%d" % (i, j))
        with open(chunk_path, "rb") as f:
            old = np.frombuffer(zlib.decompress(f.read()), np.float32).reshape(
                ZARR_CHUNK, ZARR_CHUNK)
        new = np.where(old == SHEET_NODATA, old, old + np.float32(100))
        with open(chunk_path, "wb") as f:
            f.write(zlib.compress(new.tobytes(), 1))
        after = get_data(source, device=device, **chunk_request)["values"]
        check(clock.calls["window reads"] == calls + 1, "zarr-store: the rewrite was not read")
    check(np.array_equal(after[0], new) and not np.array_equal(after, before),
          "zarr-store: a cached window read missed the rewritten chunk")
    print("zarr-store: chunk %d.%d rewritten in place: the cached window read again, the new "
          "values seen" % (i, j))
    shutil.rmtree(store, ignore_errors=True)
    shutil.rmtree(target, ignore_errors=True)
    phase_s = time.perf_counter() - phase_t0
    print("zarr-store: the phase %.2f s [%s]" % (phase_s, card))
    return launches, dict(write_s=write_s, store_mb=store_bytes / 1e6, info_s=info_s,
                          host_mpx_per_s=host_rate, phases_s=phases,
                          plan_split_s=plan_split, tiles=n_tiles,
                          to_zarr_s=export_s, read_back_s=read_back_s, phase_s=phase_s,
                          gaussian_launches_read=read_launches)


def netcdf_clock():
    """A PhaseClock over a netCDF file's reads: the whole decodes (the file
    read, the header, the record slabs, the CF assembly), the record slabs
    and the CF assembly apart, and the window reads."""
    from dask_geomodeling_tpu_torch.io import netcdf as netcdf_io

    return PhaseClock([(netcdf_io, "read_netcdf", "whole reads"),
                       (netcdf_io, "_read_var", "record slabs"),
                       (netcdf_io, "_assemble_raster", "CF assembly"),
                       (netcdf_io, "read_netcdf_window", "window reads")])


class gaussian_calls:
    """The (shape, dtype, sigma) of every Gaussian that Smooth's twin asks
    for while installed, in ``calls``, and the first call's (planes,
    result, sigma, fill) in ``first``."""

    def __enter__(self):
        from dask_geomodeling_tpu_torch.raster import spatial

        self.calls, self.first, self.blur = [], None, spatial.gaussian_blur

        def blur(planes, sigma_y, sigma_x, fill):
            self.calls.append((tuple(planes.shape), planes.dtype, (sigma_y, sigma_x)))
            result = self.blur(planes, sigma_y, sigma_x, fill)
            if self.first is None:
                self.first = (planes, result, (sigma_y, sigma_x), fill)
            return result

        spatial.gaussian_blur = blur
        return self

    def __exit__(self, *exc):
        from dask_geomodeling_tpu_torch.raster import spatial

        spatial.gaussian_blur = self.blur
        return False


def check_netcdf_radar(card, device, folder, records=RADAR_RECORDS, size=RADAR_SIZE,
                       px=RADAR_PX, hours=RADAR_HOURS, window_limit=RADAR_WINDOW_LIMIT,
                       sampled_tiles=8, export_px=RADAR_EXPORT_PX):
    """The netcdf-radar phase over a day of radar frames in a CDF-2 file
    (write_radar_netcdf), build_radar_view at radar_request: (a) info, a
    whole decode (timed under netcdf_clock), then the request through
    evaluate_tiled with the checks of check_algebra_path (bitwise, 8
    sampled tiles, no second get_data run), its first run's phases, the
    Gaussian's launches and the batch it was given; (b) the same request
    read by window under ``window_limit``, bitwise the whole-file answer,
    no second decode; (c) the ``quality`` variable's view on one tile
    against compute_host and unlike the rain's, and ``info`` of both
    variables equal to the whole decode and to the file's grid; (d)
    write_netcdf of the first hourly sum over an export_px^2 corner,
    packed int16 with a scale_factor, read back through RasterFileSource
    within half a packing step; (e) an HDF5 file under ``.nc4`` raising the
    h5py gate (NotImplementedError naming h5py) without h5py and OSError
    with it, and an HDF4 ``.hdf`` of no data set the HDF4 reader's
    ValueError.
    Returns (launches, numbers, (the Gaussian's batch shape, sigma));
    removes the files."""
    import importlib.util

    from dask_geomodeling_tpu_torch import evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.io.netcdf import write_netcdf
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    path, written = write_radar_netcdf(folder, records, size)
    write_s = time.perf_counter() - t0
    print("netcdf-radar: %d 5-minute frames of %d^2 (int16 rain, int8 quality) written as a "
          "CDF-2 file in %.2f s, %.1f MB [%s]" % (records, size, write_s, written / 1e6, card))
    view = build_radar_view(path)
    source = view.args[0].args[0]
    request = radar_request(size, px, hours=hours)
    tiles, _ = tile_requests(request, TILE)

    # (a) the header (a whole decode, kept in the read cache), then the path
    with netcdf_clock() as clock:
        t0 = time.perf_counter()
        info = source.info
        decode_s = time.perf_counter() - t0
    decode = dict(clock.seconds)
    check(clock.calls["whole reads"] == 1, "netcdf-radar: info decoded %d times"
          % clock.calls["whole reads"])
    cuda_stencils.reset_launches()
    phases, spy = {}, gaussian_calls()
    host_rate, values = check_algebra_path(
        "netcdf-radar", device, view, request, "nearest", (request["bbox"][0], request["bbox"][3]),
        share=0.0, sampled_tiles=sampled_tiles, first_run=(spy, phases), routed=False,
        gaussian_launches=2)
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    check(launches["gaussian_blur"] > 0, "netcdf-radar: the Gaussian did not launch")
    check(values.shape == (3, px, px) and values.dtype == np.float32,
          "netcdf-radar: %s %s, not 3 hourly float32 bands" % (values.shape, values.dtype))
    check(len(spy.calls) == -(-len(tiles) // BATCH), "netcdf-radar: %d Gaussians for %d tiles"
          % (len(spy.calls), len(tiles)))
    planes, _, sigma = spy.calls[0]
    run_s = sum(phases.values())
    print("netcdf-radar: info %.3f s (a whole decode: record slabs %.3f s, CF assembly %.3f s); "
          "%d tiles, %d frames into %d hourly sums, Gaussian %d launches on %s sigma (%.4f, "
          "%.4f); first run %s, %.3f Mpx/s [%s]" % (
              decode_s, decode["record slabs"], decode["CF assembly"], len(tiles),
              (request["stop"] - request["start"]) // RADAR_STEP + 1, values.shape[0],
              launches["gaussian_blur"], planes, sigma[0], sigma[1],
              ", ".join("%s %.4f s" % kv for kv in phases.items()), px * px / 1e6 / run_s, card))

    # (b) read by window: the same answer, no second decode
    with config.set({"geomodeling.windowed-read-limit": window_limit}):
        check(source._file_read_plan(tiles[0]) is not None, "netcdf-radar: the read is not "
              "windowed under the limit")
        with netcdf_clock() as clock:
            t0 = time.perf_counter()
            windowed = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH,
                                      device=device)["values"]
            windowed_s = time.perf_counter() - t0
    check(np.array_equal(windowed, values), "netcdf-radar: the windowed answer differs")
    check(clock.calls["whole reads"] == 0 and clock.calls["window reads"] >= len(tiles),
          "netcdf-radar: %d whole and %d window reads by window"
          % (clock.calls["whole reads"], clock.calls["window reads"]))
    del windowed
    print("netcdf-radar: by window (windowed-read-limit %d) in %.3f s, %d window reads, no "
          "decode, bitwise the whole-file answer" % (window_limit, windowed_s,
                                                     clock.calls["window reads"]))

    # (c) the other record variable, and info of both
    tile = tiles[len(tiles) // 2]
    quality = build_radar_view(path, "quality")
    card_quality = get_data(quality, device=device, **tile)["values"]
    host_quality = host_values(quality, tile)
    check(card_quality.dtype == host_quality.dtype and np.array_equal(card_quality, host_quality),
          "netcdf-radar: the quality view differs from compute_host")
    check(not np.array_equal(card_quality, get_data(view, device=device, **tile)["values"]),
          "netcdf-radar: the quality view answers the rain's")
    expected = dict(width=size, height=size, bands=records, projection="EPSG:28992",
                    geo_transform=(RADAR_ORIGIN[0], RADAR_CELL, 0.0, RADAR_ORIGIN[1], 0.0,
                                   -RADAR_CELL))
    for variable, dtype, nodata in ((None, "float32", float(np.finfo(np.float32).max)),
                                    ("quality", "int8", 127.0)):
        got = RasterFileSource(path, variable=variable).info
        whole = pipeline.read_geotiff_cached(path, variable)
        check((got.width, got.height, got.bands, got.dtype, tuple(got.geo_transform),
               got.no_data_value, got.projection)
              == (whole.array.shape[2], whole.array.shape[1], whole.array.shape[0],
                  str(whole.array.dtype), tuple(whole.geo_transform), whole.no_data_value,
                  whole.projection)
              == (expected["width"], expected["height"], expected["bands"], dtype,
                  expected["geo_transform"], nodata, expected["projection"]),
              "netcdf-radar: info of %s differs from the whole decode" % variable)
    print("netcdf-radar: quality (%s) on a tile equal to compute_host, unlike the rain; info of "
          "both equal to the whole decode" % card_quality.dtype)

    # (d) one hourly sum over a corner, packed int16, read back
    x1, _, _, y2 = request["bbox"]
    cell = RADAR_REQUEST_CELL
    sub = (x1, y2 - export_px * cell, x1 + export_px * cell, y2)
    sub_request = dict(request, bbox=sub, width=export_px, height=export_px)
    hourly = get_data(view, device=device, **sub_request)
    sums, nodata = hourly["values"][0], hourly["no_data_value"]
    packed = np.where(sums == nodata, RADAR_FILL, np.round(sums / RADAR_SCALE)).astype(np.int16)
    target = os.path.join(folder, "hourly.nc")
    t0 = time.perf_counter()
    write_netcdf(target, packed, (sub[0], cell, 0.0, sub[3], 0.0, -cell),
                 projection="EPSG:28992", no_data_value=RADAR_FILL, scale_factor=RADAR_SCALE)
    export_s = time.perf_counter() - t0
    back = get_data(RasterFileSource(target), device=device, mode="vals", bbox=sub,
                    projection="EPSG:28992", width=export_px, height=export_px)
    data = sums != nodata
    err = float(np.abs(back["values"][0][data] - sums[data]).max()) if data.any() else 0.0
    check(np.array_equal(back["values"][0] == back["no_data_value"], ~data)
          and err <= RADAR_SCALE / 2 * 1.001,
          "netcdf-radar: the packed export differs by %r" % err)
    print("netcdf-radar: write_netcdf of one hourly sum over %d^2 (int16, scale_factor %g) in "
          "%.3f s, read back within %r of the card's sums" % (export_px, RADAR_SCALE, export_s,
                                                              err))

    # (e) the gates
    hdf5 = os.path.join(folder, "gate.nc4")
    hdf4 = os.path.join(folder, "gate.hdf")
    with open(hdf5, "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with open(hdf4, "wb") as f:
        f.write(b"\x0e\x03\x13\x01" + b"\0" * 64)
    has_h5py = importlib.util.find_spec("h5py") is not None

    def raised_by(call):
        try:
            call()
        except (NotImplementedError, OSError, ValueError) as e:
            return e
        return None

    raised = raised_by(lambda: RasterFileSource(hdf5).info)
    check(isinstance(raised, OSError) if has_h5py else
          isinstance(raised, NotImplementedError) and "h5py" in str(raised),
          "netcdf-radar: an HDF5 .nc4 raised %r" % raised)
    # an .hdf with HDF4's magic reaches the HDF4 reader, not the netCDF one
    for call in (lambda: RasterFileSource(hdf4).info, lambda: pipeline.read_geotiff_cached(hdf4)):
        hdf4_error = raised_by(call)
        check(isinstance(hdf4_error, ValueError)
              and str(hdf4_error).startswith("HDF4 file contains no 2-D/3-D data sets"),
              "netcdf-radar: an HDF4 .hdf raised %r" % hdf4_error)
    print("netcdf-radar: gates: an HDF5 .nc4 raised %s (h5py %s), an HDF4 .hdf the HDF4 "
          "reader's ValueError: %s" % (type(raised).__name__,
                                       "present" if has_h5py else "missing", hdf4_error))
    for name in (path, target, hdf5, hdf4):
        os.remove(name)
    pipeline.clear_read_cache()
    phase_s = time.perf_counter() - phase_t0
    print("netcdf-radar: the phase %.2f s [%s]" % (phase_s, card))
    return launches, dict(write_s=write_s, file_mb=written / 1e6, info_decode_s=decode_s,
                          decode_split_s=decode, host_mpx_per_s=host_rate, phases_s=phases,
                          mpx_per_s=px * px / 1e6 / run_s, windowed_s=windowed_s,
                          export_s=export_s, export_err=err, phase_s=phase_s,
                          tiles=len(tiles)), (planes, sigma)


def hfa_clock():
    """A PhaseClock over an HFA file's reads: the whole reads and the
    ESRI-GRID-RLE blocks they decode."""
    from dask_geomodeling_tpu_torch.io import hfa as hfa_io

    return PhaseClock([(hfa_io, "read_hfa", "whole reads"),
                       (hfa_io, "_rle_decode", "RLE blocks")])


def check_hfa_roughness(card, device, folder, width=LGN_WIDTH, height=LGN_HEIGHT,
                        sampled_tiles=LGN_SAMPLED):
    """The hfa-roughness phase over a land-use grid (write_lgn: an ERDAS
    Imagine file with ESRI-GRID-RLE blocks and a PAM attribute table),
    build_lgn_view at lgn_request: info, a whole decode (timed under
    hfa_clock, every spliced block decoded once), then the request through
    evaluate_tiled with the checks of check_algebra_path (bitwise, 8
    sampled tiles, no second get_data run) and no second read of the file;
    the reclassified friction on a tile at the coast, on the card, nodata
    exactly where the class is 0 or not in the table and the table's
    Manning's n elsewhere; a rewritten sidecar changes the next view's
    answer, as compute_host's; the Gaussian's first launch on the path
    torch.equal to its plain version on the same frames; time_path's
    numbers.  Returns (launches, numbers, the Gaussian's kernel record
    numbers, {"classes", "values": the first run's answer} for
    tile-pyramids); removes the files."""
    import torch

    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.io.pam import (
        read_raster_attribute_table,
        write_raster_attribute_table,
    )
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    path, classes, (spliced, blocks) = write_lgn(folder, width, height)
    write_s = time.perf_counter() - t0
    file_mb = os.path.getsize(path) / 1e6
    print("hfa-roughness: %d x %d uint8 land-use classes of %g m in EPSG:28992 written with "
          "write_hfa in 64^2 blocks, %d of %d spliced into ESRI-GRID-RLE, with a PAM attribute "
          "table of %d classes: %.1f MB in %.2f s [%s]" % (
              width, height, LGN_CELL, spliced, blocks,
              len(LGN_CLASSES) - len(LGN_UNLISTED), file_mb, write_s, card))
    check(0 < spliced < blocks, "hfa-roughness: %d of %d blocks compressed, not a mix"
          % (spliced, blocks))
    # the header: a whole decode, kept in the read cache for the view
    with hfa_clock() as clock:
        t0 = time.perf_counter()
        info = RasterFileSource(path).info
        decode_s = time.perf_counter() - t0
    view = build_lgn_view(path)
    reclassified = view.args[0]
    source = reclassified.args[0]
    request = lgn_request(width, height)
    tiles, nx = tile_requests(request, TILE)
    check(clock.calls["whole reads"] == 1 and clock.calls["RLE blocks"] == spliced,
          "hfa-roughness: info made %d whole reads of %d RLE blocks, not 1 of %d"
          % (clock.calls["whole reads"], clock.calls["RLE blocks"], spliced))
    got = (info.width, info.height, info.bands, info.dtype, info.projection,
           info.no_data_value, tuple(info.geo_transform))
    check(got == (width, height, 1, "uint8", "EPSG:28992", 0.0, LGN_GEO_TRANSFORM)
          and source.fillvalue == 0 and np.array_equal(
              pipeline.read_geotiff_cached(path).array[0], classes),
          "hfa-roughness: info %r, fill %r" % (got, source.fillvalue))
    print("hfa-roughness: info (a whole decode, %d RLE blocks) in %.3f s: %d x %d %s, %s, "
          "fill %d from Eimg_NonInitializedValue; the decode equals the classes written"
          % (clock.calls["RLE blocks"], decode_s, info.width, info.height, info.dtype,
             info.projection, source.fillvalue))

    # the path: read whole once (above), never again, nor by window
    cuda_stencils.reset_launches()
    phases, spy = {}, gaussian_calls()
    with hfa_clock() as clock:
        host_rate, values = check_algebra_path(
            "hfa-roughness", device, view, request, "nearest",
            (request["bbox"][0], request["bbox"][3]), share=0.0, sampled_tiles=sampled_tiles,
            first_run=(spy, phases), routed=False)
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    check(launches["gaussian_blur"] > 0, "hfa-roughness: the Gaussian did not launch")
    check(clock.calls["whole reads"] == 0, "hfa-roughness: the file was read again")
    check(source._file_read_plan(tiles[0]) is None, "hfa-roughness: the read is windowed")
    check(values.shape == (1, height, width) and values.dtype == np.float64,
          "hfa-roughness: %s %s, not one float64 band" % (values.shape, values.dtype))
    check(len(spy.calls) == -(-len(tiles) // BATCH), "hfa-roughness: %d Gaussians for %d tiles"
          % (len(spy.calls), len(tiles)))
    planes, path_result, sigma, fill = spy.first
    first_mpx = width * height / 1e6 / sum(phases.values())
    print("hfa-roughness: %d tiles, Gaussian %d launches on %s %s sigma (%.4f, %.4f); first "
          "run %s, %.3f Mpx/s [%s]" % (
              len(tiles), launches["gaussian_blur"], tuple(planes.shape),
              str(planes.dtype).replace("torch.", ""), sigma[0], sigma[1],
              ", ".join("%s %.4f s" % kv for kv in phases.items()), first_mpx, card))

    # the friction on a tile at the coast (the middle row's, in the tile
    # column of the coastline's mean): nodata exactly at class 0 and the
    # classes the table leaves out, the table's n elsewhere
    k = (len(tiles) // nx // 2) * nx + int(width * LGN_SEA_SHARE) // TILE
    (rows, cols), (tile_rows, tile_cols) = tile_cells(k, nx, width, height, TILE)
    tile_classes = classes[rows, cols]
    friction = get_data(reclassified, device=device, **tiles[k])
    cells = friction["values"][0][tile_rows, tile_cols]
    missing = np.isin(tile_classes, (0,) + LGN_UNLISTED)
    manning = np.zeros(256)
    for code, _, n in LGN_CLASSES:
        manning[code] = n
    check(missing.any() and not missing.all()
          and np.array_equal(cells == friction["no_data_value"], missing)
          and np.array_equal(cells[~missing], manning[tile_classes[~missing]]),
          "hfa-roughness: the friction on tile %d is not the table's" % k)

    # a rewritten sidecar: the next view reclassifies with the new table,
    # in which the tile's most common listed class has twice its n
    rat = read_raster_attribute_table(path)
    before = get_data(view, device=device, **tiles[k])["values"]
    common = int(np.bincount(tile_classes[~missing]).argmax())
    rat["rows"] = [row[:2] + [row[2] * 2] + row[3:] if row[0] == common else row
                   for row in rat["rows"]]
    write_raster_attribute_table(path, rat)
    rewritten = build_lgn_view(path)
    after = get_data(rewritten, device=device, **tiles[k])["values"]
    check(not np.array_equal(after, before)
          and np.array_equal(after, host_values(rewritten, tiles[k])),
          "hfa-roughness: the rewritten table did not change the answer as compute_host's")
    print("hfa-roughness: the friction on coast tile %d nodata in its %d cells of class 0 or "
          "unlisted, the table's n elsewhere; class %d's n doubled in the sidecar changes the "
          "next view's answer, equal to compute_host" % (k, int(missing.sum()), common))

    timing = time_path("hfa-roughness", card, view, request, device, host_rate)

    # the Gaussian's first launch on the path against its plain version
    want = gaussian_blur_reference(planes, *sigma, fill)
    check(torch.equal(path_result, want), "gaussian_blur differs from its plain version on the "
          "hfa-roughness path's frames")
    err = float((path_result - want).abs().max())
    print("kernel check: gaussian_blur hfa-roughness batch %s %s sigma=(%.6f, %.6f), the "
          "path's own frames: equal=True max_abs_err=%r" % (
              tuple(planes.shape), str(planes.dtype).replace("torch.", ""), sigma[0], sigma[1],
              err))
    kernel = dict(time_gaussian(planes, sigma), max_abs_err=err, path="hfa-roughness")
    del planes, path_result, want, spy
    os.remove(path)
    os.remove(path + ".aux.xml")
    pipeline.clear_read_cache()
    phase_s = time.perf_counter() - phase_t0
    print("hfa-roughness: the phase %.2f s [%s]" % (phase_s, card))
    return launches, dict(timing, write_s=write_s, file_mb=file_mb, rle_blocks=spliced,
                          blocks=blocks, decode_s=decode_s, first_phases_s=phases,
                          tiles=len(tiles), phase_s=phase_s,
                          gaussian_batch=kernel["shape"]), kernel, dict(classes=classes,
                                                                      values=values)


#: the tile-pyramids path: the hfa-roughness land use as raster tile
#: pyramids, a GeoPackage of 256^2 PNG tiles in RD New and MBTiles at
#: zoom 14 (cells of 9.55 m in EPSG:3857, about 5.9 m on the ground here)
PYRAMID_TILE = 256
PYRAMID_ZOOM = 14
PYRAMID_SAMPLED = 8
MERCATOR_ORIGIN = 20037508.342789244  # half the Web Mercator world's width


def write_lgn_gpkg(folder, classes, name="lgn.gpkg"):
    """Write ``classes`` (rows, columns of uint8) to ``folder``/``name``
    with the port's write_gpkg_raster: PYRAMID_TILE^2 PNG tiles of
    LGN_CELL m from LGN_ORIGIN in EPSG:28992, the last column and row of
    tiles padded with class 0.  Returns the path."""
    from dask_geomodeling_tpu_torch.io.gpkg_raster import write_gpkg_raster

    path = os.path.join(folder, name)
    write_gpkg_raster(path, classes[np.newaxis], LGN_GEO_TRANSFORM, projection="EPSG:28992",
                      tile_size=PYRAMID_TILE)
    return path


def mercator_box(request, zoom=PYRAMID_ZOOM, tile=PYRAMID_TILE):
    """The geo_transform, width and height of the smallest box of whole
    zoom-``zoom`` Web Mercator tiles around the footprint of
    ``request`` (its bbox transformed into EPSG:3857 by the port)."""
    import math

    from dask_geomodeling_tpu_torch.geo import Extent

    x1, y1, x2, y2 = Extent(request["bbox"], request["projection"]).transformed(
        "EPSG:3857").bbox
    cell = 2 * MERCATOR_ORIGIN / (tile << zoom)
    span = tile * cell
    col0, col1 = (math.floor((x1 + MERCATOR_ORIGIN) / span),
                  math.ceil((x2 + MERCATOR_ORIGIN) / span))
    row0, row1 = (math.floor((MERCATOR_ORIGIN - y2) / span),
                  math.ceil((MERCATOR_ORIGIN - y1) / span))
    geo_transform = (-MERCATOR_ORIGIN + col0 * span, cell, 0.0,
                     MERCATOR_ORIGIN - row0 * span, 0.0, -cell)
    return geo_transform, (col1 - col0) * tile, (row1 - row0) * tile


def write_lgn_mbtiles(folder, request, zoom=PYRAMID_ZOOM, name="lgn.mbtiles"):
    """Draw lgn_classes at the size of mercator_box(request, zoom) and
    write them to ``folder``/``name`` with the port's write_mbtiles (one
    zoom level of PNG tiles, TMS rows).  Returns (path, classes,
    geo_transform)."""
    from dask_geomodeling_tpu_torch.io.mbtiles import write_mbtiles

    geo_transform, width, height = mercator_box(request, zoom)
    classes = lgn_classes(width, height)
    path = os.path.join(folder, name)
    write_mbtiles(path, classes[np.newaxis], geo_transform, projection="EPSG:3857", name="lgn",
                  tile_size=PYRAMID_TILE)
    return path, classes, geo_transform


def build_pyramid_view(path, classes):
    """build_lgn_view's chain over the pyramid at ``path``, the table
    lgn_rat(classes) passed in: a tile pyramid carries no PAM sidecar."""
    from dask_geomodeling_tpu_torch.io.pam import rat_as_reclassify_data
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Reclassify, Smooth

    data = rat_as_reclassify_data(lgn_rat(classes), "MANNING")
    return Smooth(Reclassify(RasterFileSource(path), data, select=True), LGN_SMOOTH_M)


def pyramid_clock():
    """A PhaseClock over the tile pyramids' reads: the whole reads of a
    GeoPackage and of an MBTiles file, and the tiles they decode."""
    from dask_geomodeling_tpu_torch.io import gpkg_raster, mbtiles

    return PhaseClock([(gpkg_raster, "read_gpkg_raster", "gpkg reads"),
                       (mbtiles, "read_mbtiles", "mbtiles reads"),
                       (gpkg_raster, "_decode_tile", "tiles decoded")])


def pyramid_refusals(folder):
    """RasterFileSource.info over (a GeoPackage of features, an MBTiles
    file whose one tile is an animated WebP, the fixture of
    tests/data/torch_webp, an MBTiles file of vector tiles): the
    (exception type, message) of each."""
    import sqlite3

    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.io.mbtiles import write_mbtiles
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    features = os.path.join(folder, "features.gpkg")
    write_vector(GeoDataFrame({"geometry": [box(*LGN_ORIGIN, LGN_ORIGIN[0] + 5, LGN_ORIGIN[1] + 5)],
                               "code": [1]}, crs="EPSG:28992"), features)
    webp = os.path.join(folder, "webp.mbtiles")
    geo_transform = mercator_box(lgn_request(1, 1))[0]
    write_mbtiles(webp, np.zeros((1, PYRAMID_TILE, PYRAMID_TILE), np.uint8), geo_transform)
    con = sqlite3.connect(webp)
    # an animated WebP: the port decodes still images only
    with open(os.path.join(webp_fixture_hashes()[0], "animated-2x16x16.webp"), "rb") as f:
        con.execute("UPDATE tiles SET tile_data = ?", (f.read(),))
    con.commit()
    con.close()
    vector = os.path.join(folder, "vector.mbtiles")
    con = sqlite3.connect(vector)
    con.execute("CREATE TABLE metadata (name TEXT, value TEXT)")
    con.execute("INSERT INTO metadata VALUES ('format', 'pbf')")
    con.commit()
    con.close()
    answers = []
    for path in (features, webp, vector):
        try:
            RasterFileSource(path).info
            answers.append((None, None))
        except Exception as e:  # the answer is the exception
            answers.append((type(e), str(e)))
        os.remove(path)
    return answers


def check_tile_pyramids(card, device, folder, lgn, sampled_tiles=PYRAMID_SAMPLED):
    """The tile-pyramids phase: (a) ``lgn["classes"]`` (hfa-roughness') as
    a GeoPackage (write_lgn_gpkg), build_pyramid_view at lgn_request: info
    and the first run one whole decode of every tile once (pyramid_clock),
    no windowed read, the checks of check_algebra_path (a 64^2 corner and
    one sampled tile bitwise, no second get_data run), every cell equal to
    ``lgn["values"]`` (hfa-roughness' answer; both are taken out of ``lgn``
    once used, so that their memory is freed before the timed runs), the
    Gaussian once a batch and its
    first launch torch.equal to its plain version, time_path's numbers; (b)
    the same chain over write_lgn_mbtiles at the same request, a cross-CRS
    nearest read: the decoded mosaic equal to the classes drawn, north and
    south strips included, the checks of check_algebra_path with at most
    HEADLINE_SHARE of ``sampled_tiles`` tiles' cells off compute_host, the
    first run's phases; (c) (a)'s view through pickle: the same class and
    token, one tile's answer on the card equal to the original's; (d)
    pyramid_refusals, each the JAX package's error.  Returns (launches,
    numbers); removes the files."""
    import pickle

    import torch

    from dask_geomodeling_tpu_torch import get_data
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    classes = lgn.pop("classes")
    height, width = classes.shape
    request = lgn_request(width, height)
    corner = (request["bbox"][0], request["bbox"][3])
    tiles, nx = tile_requests(request, TILE)
    batches = -(-len(tiles) // BATCH)
    batches_before = tile_runtime.batches_run
    numbers = {}

    # (a) the GeoPackage in RD New
    t0 = time.perf_counter()
    path = write_lgn_gpkg(folder, classes)
    numbers["gpkg_write_s"] = time.perf_counter() - t0
    numbers["gpkg_mb"] = os.path.getsize(path) / 1e6
    n_tiles = -(-width // PYRAMID_TILE) * -(-height // PYRAMID_TILE)
    phases, spy = {}, gaussian_calls()
    with pyramid_clock() as clock:
        # Reclassify reads the source's dtype, so its info, as it is built
        t0 = time.perf_counter()
        view = build_pyramid_view(path, classes)
        source = view.args[0].args[0]
        info = source.info
        numbers["gpkg_info_s"] = time.perf_counter() - t0
        mosaic = pipeline.read_geotiff_cached(path).array
        got = (info.width, info.height, info.bands, info.dtype, info.projection,
               info.no_data_value, tuple(info.geo_transform))
        check(got == (-(-width // PYRAMID_TILE) * PYRAMID_TILE,
                      -(-height // PYRAMID_TILE) * PYRAMID_TILE, 1, "uint8", "EPSG:28992", None,
                      LGN_GEO_TRANSFORM)
              and np.array_equal(mosaic[0, :height, :width], classes)
              and not mosaic[0, height:].any() and not mosaic[0, :, width:].any(),
              "gpkg-landuse: info %r, or the mosaic is not the classes padded with 0" % (got,))
        del classes, mosaic
        cuda_stencils.reset_launches()
        host_rate, values = check_algebra_path(
            "gpkg-landuse", device, view, request, "nearest", corner, share=0.0, sampled_tiles=1,
            first_run=(spy, phases), routed=False)
    gpkg_launches = cuda_stencils.launches
    check(clock.calls["gpkg reads"] == 1 and clock.calls["tiles decoded"] == n_tiles,
          "gpkg-landuse: info and the run made %d whole reads of %d tiles, not 1 of %d"
          % (clock.calls["gpkg reads"], clock.calls["tiles decoded"], n_tiles))
    check(gpkg_launches > 0, "gpkg-landuse: the Gaussian did not launch")
    check(source._file_read_plan(tiles[0]) is None, "gpkg-landuse: the read is windowed")
    check(len(spy.calls) == batches, "gpkg-landuse: %d Gaussians for %d tiles"
          % (len(spy.calls), len(tiles)))
    expected = lgn.pop("values")
    check(values.shape == expected.shape and values.dtype == expected.dtype
          and np.array_equal(values, expected),
          "gpkg-landuse: %d cells differ from hfa-roughness' answer"
          % np.count_nonzero(values != expected))
    dtype = str(values.dtype)
    del expected, values
    planes, path_result, sigma, fill = spy.first
    want = gaussian_blur_reference(planes, *sigma, fill)
    check(torch.equal(path_result, want), "gaussian_blur differs from its plain version on the "
          "gpkg-landuse path's frames")
    numbers["gpkg_first_phases_s"] = phases
    print("gpkg-landuse: %d x %d classes as %d PNG tiles of %d^2 in EPSG:28992, %.1f MB written "
          "in %.2f s; info (a whole decode of every tile once) %.3f s; %d tiles, Gaussian %d "
          "launches on %s %s, its first torch.equal to its plain version; first run %s; every "
          "cell of the %s answer equal to hfa-roughness' [%s]" % (
              width, height, n_tiles, PYRAMID_TILE, numbers["gpkg_mb"], numbers["gpkg_write_s"],
              numbers["gpkg_info_s"], len(tiles), gpkg_launches, tuple(planes.shape),
              str(planes.dtype).replace("torch.", ""),
              ", ".join("%s %.4f s" % kv for kv in phases.items()), dtype, card))
    del planes, path_result, want, spy

    # (c) the view through pickle, before its timing
    copy = pickle.loads(pickle.dumps(view))
    k = len(tiles) // 2
    original = torch.from_numpy(get_data(view, device=device, **tiles[k])["values"])
    unpickled = torch.from_numpy(get_data(copy, device=device, **tiles[k])["values"])
    check(type(copy) is type(view) and copy.token == view.token
          and torch.equal(unpickled, original),
          "tile-pyramids: the unpickled view differs from the original")
    print("tile-pyramids: gpkg-landuse's view pickled (%d bytes) and unpickled: token %s kept, "
          "tile %d on the card equal to the original's" % (
              len(pickle.dumps(view)), copy.token, k))
    timing = time_path("gpkg-landuse", card, view, request, device, host_rate)
    os.remove(path)
    pipeline.clear_read_cache()

    # (b) MBTiles at zoom 14, read into RD New
    t0 = time.perf_counter()
    path, mb_classes, geo_transform = write_lgn_mbtiles(folder, request)
    numbers["mbtiles_write_s"] = time.perf_counter() - t0
    numbers["mbtiles_mb"] = os.path.getsize(path) / 1e6
    mb_height, mb_width = mb_classes.shape
    phases, spy = {}, gaussian_calls()
    with pyramid_clock() as clock:
        t0 = time.perf_counter()
        view = build_pyramid_view(path, mb_classes)
        source = view.args[0].args[0]
        info = source.info
        numbers["mbtiles_info_s"] = time.perf_counter() - t0
        cuda_stencils.reset_launches()
        host_rate, values = check_algebra_path(
            "mbtiles-landuse", device, view, request, "nearest", corner, share=HEADLINE_SHARE,
            sampled_tiles=sampled_tiles, first_run=(spy, phases), routed=False)
    mbtiles_launches = cuda_stencils.launches
    del values
    mosaic = pipeline.read_geotiff_cached(path).array[0]
    n_tiles = mb_width * mb_height // PYRAMID_TILE**2
    got = (info.width, info.height, info.bands, info.dtype, info.projection,
           info.no_data_value, info.metadata)
    check(got == (mb_width, mb_height, 1, "uint8", "EPSG:3857", None, ["lgn"])
          and np.allclose(info.geo_transform, geo_transform, rtol=1e-12),
          "mbtiles-landuse: info %r %r" % (got, info.geo_transform))
    strip = PYRAMID_TILE
    check(np.array_equal(mosaic[:strip], mb_classes[:strip])
          and np.array_equal(mosaic[-strip:], mb_classes[-strip:])
          and np.array_equal(mosaic, mb_classes),
          "mbtiles-landuse: the mosaic's strips are not the classes drawn (the TMS row flip)")
    check(clock.calls["mbtiles reads"] == 1 and clock.calls["tiles decoded"] == n_tiles,
          "mbtiles-landuse: info and the run made %d whole reads of %d tiles, not 1 of %d"
          % (clock.calls["mbtiles reads"], clock.calls["tiles decoded"], n_tiles))
    check(mbtiles_launches > 0, "mbtiles-landuse: the Gaussian did not launch")
    check(source._file_read_plan(tiles[0]) is None, "mbtiles-landuse: the read is windowed")
    check(len(spy.calls) == batches, "mbtiles-landuse: %d Gaussians for %d tiles"
          % (len(spy.calls), len(tiles)))
    numbers["mbtiles_first_phases_s"] = phases
    print("mbtiles-landuse: %d x %d classes as %d PNG tiles of zoom %d (%.6f m cells) in "
          "EPSG:3857, x %.0f-%.0f m, y %.0f-%.0f m, %.1f MB written in %.2f s; info (a whole "
          "decode) %.3f s, the mosaic equal to the classes drawn, its north and south strips "
          "too (TMS rows); asked in EPSG:28992: Gaussian %d launches; first run %s [%s]" % (
              mb_width, mb_height, n_tiles, PYRAMID_ZOOM, geo_transform[1], geo_transform[0],
              geo_transform[0] + mb_width * geo_transform[1],
              geo_transform[3] + mb_height * geo_transform[5], geo_transform[3],
              numbers["mbtiles_mb"], numbers["mbtiles_write_s"], numbers["mbtiles_info_s"],
              mbtiles_launches, ", ".join("%s %.4f s" % kv for kv in phases.items()), card))
    del mosaic, spy
    os.remove(path)
    pipeline.clear_read_cache()

    # (d) the refusals
    refusals = pyramid_refusals(folder)
    expected_refusals = [(OSError, "No tile layers in '"), (NotImplementedError, "io/gpkg_raster.py"),
                         (OSError, "vector tiles")]
    for (kind, message), (want_kind, fragment) in zip(refusals, expected_refusals):
        check(kind is want_kind and fragment in message,
              "tile-pyramids: a refusal raised %r %r, not %s naming %r"
              % (kind, message, want_kind.__name__, fragment))
    print("tile-pyramids: refused with the JAX package's errors: %s" % "; ".join(
        "%s: %s" % (kind.__name__, message) for kind, message in refusals))

    numbers["batches_run"] = tile_runtime.batches_run - batches_before
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("tile-pyramids: tiles.batches_run %d; the phase %.2f s [%s]"
          % (numbers["batches_run"], numbers["phase_s"], card))
    launches = {"gaussian_blur": gpkg_launches + mbtiles_launches,
                "moving_max": cuda_stencils.moving_max_launches}
    return launches, dict(timing, **numbers)


#: the modis-ndvi path: a MOD13Q1-style 16-day vegetation index tile,
#: h18v03 (the Netherlands, the North Sea and Germany to the Baltic), in
#: the MODIS sinusoidal grid, as an HDF4 file: three int16 scientific data
#: sets of the SD API in 480^2 chunks
MODIS_TILE = "h18v03"
MODIS_SIZE = 4800
MODIS_CHUNK = 480
MODIS_RADIUS = 6371007.181  # the MODIS sinusoidal sphere
MODIS_UPPER_LEFT = (0.0, 6671703.118)
MODIS_LOWER_RIGHT = (1111950.519667, 5559752.598333)
MODIS_PROJECTION = "+proj=sinu +R=6371007.18 +lon_0=0 +x_0=0 +y_0=0 +units=m +no_defs"
MODIS_SETS = ("250m 16 days NDVI", "250m 16 days EVI", "250m 16 days pixel reliability")
MODIS_FILL = -3000
MODIS_SCALE = 0.0001
MODIS_DEFLATE_LEVEL = 6
#: the pixel-reliability set's chunks szip-coded (the other MODIS layout,
#: through the system libsz): not on the card's machine, which has no
#: libsz (nor libaec), so its chunks are deflate too; the CPU tests write
#: them with szip
MODIS_SZIP = False
#: szip's parameters for big-endian int16 cells: nearest neighbour
#: preprocessing, entropy coding, most significant byte first, K13
MODIS_SZIP_OPTIONS = 32 | 4 | 16 | 1
MODIS_SZIP_BLOCK = 32
MODIS_SMOOTH_M = 500.0
MODIS_BINS = [0.2, 0.4, 0.6, 0.8]  # NDVI classes: bare, sparse, open, dense, closed canopy
#: (b): the Netherlands in RD New at 100 m
MODIS_RD_BBOX = (10000.0, 300000.0, 290000.0, 630000.0)
MODIS_RD_CELL = 100.0
#: below the tile's cells, so that each request tile reads its window
MODIS_WINDOW_LIMIT = 1000000
MODIS_SAMPLED = 8
MODIS_COMPOSITE = datetime(2021, 7, 12)  # A2021193, the composite's first day

HDF4_MAGIC = b"\x0e\x03\x13\x01"
#: HDF4 tags (htags.h) and the special-element flag
HDF4_TAGS = dict(compressed=40, chunk=61, nt=106, sdd=701, sd=702, ndg=720, vh=1962, vs=1963,
                 vg=1965)
HDF4_SPECIAL = 0x4000


def modis_fields(size=MODIS_SIZE, seed=25):
    """The stored int16 NDVI, EVI and pixel reliability of the tile (rows
    north to south): smooth vegetation over land with a little noise, the
    North Sea west of a wavy coast and a Baltic bay in the north-east at
    the fill value, and cloud patches at the fill value (reliability 3,
    cloudy, there; 0 or 1 on land)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, size, dtype=np.float32)
    y, x = t[:, None], t[None, :]
    ndvi = (0.55 + 0.2 * np.sin(7 * x + 3 * y) * np.cos(5 * y - 2 * x)
            + 0.1 * np.sin(23 * x) * np.sin(19 * y))
    ndvi = ndvi + rng.normal(0, 0.02, (size, size)).astype(np.float32)
    evi = 0.6 * ndvi + rng.normal(0, 0.01, (size, size)).astype(np.float32)
    coast = 0.27 + 0.25 * np.clip(0.6 - y, 0, None) + 0.02 * np.sin(25 * y)
    water = (x < coast) | ((x - 0.85) ** 2 + (y - 0.15) ** 2 < 0.03)
    cloud = np.zeros((size, size), bool)
    for _ in range(40):
        cy, cx = rng.rand(2)
        ry, rx = 0.005 + 0.025 * rng.rand(2)
        rows = slice(max(0, int((cy - ry) * size)), int((cy + ry) * size) + 1)
        cols = slice(max(0, int((cx - rx) * size)), int((cx + rx) * size) + 1)
        cloud[rows, cols] |= (((y[rows] - cy) / ry) ** 2 + ((x[:, cols] - cx) / rx) ** 2) < 1
    fill = water | cloud
    stored = []
    for index in (ndvi, evi):
        values = np.rint(np.clip(index, -0.2, 1.0) / MODIS_SCALE).astype(np.int16)
        values[fill] = MODIS_FILL
        stored.append(values)
    reliability = (ndvi < 0.3).astype(np.int16)
    reliability[cloud] = 3
    reliability[water] = MODIS_FILL
    return stored + [reliability]


def modis_struct_metadata(size=MODIS_SIZE):
    """The tile's StructMetadata.0 (HDF-EOS ODL): one sinusoidal grid."""
    return "\n".join([
        "GROUP=SwathStructure", "END_GROUP=SwathStructure", "GROUP=GridStructure",
        "\tGROUP=GRID_1", '\t\tGridName="MODIS_Grid_16DAY_250m_500m_VI"',
        "\t\tXDim=%d" % size, "\t\tYDim=%d" % size,
        "\t\tUpperLeftPointMtrs=(%.6f,%.6f)" % MODIS_UPPER_LEFT,
        "\t\tLowerRightMtrs=(%.6f,%.6f)" % MODIS_LOWER_RIGHT,
        "\t\tProjection=GCTP_SNSOID",
        "\t\tProjParams=(%.6f,0,0,0,0,0,0,0,0,0,0,0,0)" % MODIS_RADIUS,
        "\t\tSphereCode=-1", "\t\tGridOrigin=HDFE_GD_UL",
        "\tEND_GROUP=GRID_1", "END_GROUP=GridStructure", "GROUP=PointStructure",
        "END_GROUP=PointStructure", "END", ""])


def hdf4_vdata(name, vclass, fields, records):
    """A Vdata's header (DFTAG_VH) and records (DFTAG_VS), fully
    interlaced: ``fields`` is [(name, number type, byte size, order)],
    ``records`` the packed record bytes."""
    recsize = sum(size for _, _, size, _ in fields)
    header = struct.pack(">hihh", 0, len(records), recsize, len(fields))
    offsets = np.cumsum([0] + [size for _, _, size, _ in fields])[:-1]
    for column in ([f[1] for f in fields], [f[2] for f in fields], offsets,
                   [f[3] for f in fields]):
        header += struct.pack(">%dh" % len(fields), *column)
    for text in [f[0] for f in fields] + [name, vclass]:
        header += struct.pack(">h", len(text)) + text.encode("latin-1")
    header += struct.pack(">HHhh", 0, 0, 3, 0)
    return header, b"".join(records)


def hdf4_attribute(name, value):
    """An SD attribute as the SD API writes it: a one-field ``Attr0.0``
    Vdata of a string, an int16 or a float64."""
    if isinstance(value, str):
        data, nt, size = value.encode("latin-1"), 4, len(value)
        return hdf4_vdata(name, "Attr0.0", [("VALUES", nt, size, size)], [data])
    dtype, nt = (">i2", 22) if isinstance(value, int) else (">f8", 6)
    item = np.dtype(dtype).itemsize
    return hdf4_vdata(name, "Attr0.0", [("VALUES", nt, item, 1)],
                      [np.array(value, dtype).tobytes()])


def hdf4_vgroup(name, vclass, members):
    """A Vgroup (DFTAG_VG) of [(tag, ref)] members."""
    body = struct.pack(">h", len(members))
    body += struct.pack(">%dH" % len(members), *[tag for tag, _ in members])
    body += struct.pack(">%dH" % len(members), *[ref for _, ref in members])
    for text in (name, vclass):
        body += struct.pack(">H", len(text)) + text.encode("latin-1")
    return body + struct.pack(">HHH", 0, 0, 3)


def hdf4_bytes(objects):
    """A whole HDF4 file: the magic, one DD block listing ``objects``
    ([(tag, ref, bytes)]) and their bytes in that order."""
    start = 4 + 6 + 12 * len(objects)
    entries, offset = [], start
    for tag, ref, data in objects:
        entries.append(struct.pack(">HHii", tag, ref, offset, len(data)))
        offset += len(data)
    return b"".join([HDF4_MAGIC, struct.pack(">hi", len(objects), 0)] + entries
                    + [data for _, _, data in objects])


def modis_chunk(values, szip):
    """(coder's description tail, coder id, coded bytes) of one chunk:
    deflate at level 6, or szip through the system libsz."""
    raw = values.astype(">i2").tobytes()
    if not szip:
        return struct.pack(">H", MODIS_DEFLATE_LEVEL), 4, zlib.compress(raw, MODIS_DEFLATE_LEVEL)
    from dask_geomodeling_tpu_torch.io.ccsds import szip_compress

    coded = szip_compress(raw, MODIS_SZIP_OPTIONS, 16, MODIS_SZIP_BLOCK, values.shape[1])
    return (struct.pack(">iiiii", values.size, values.shape[1], MODIS_SZIP_OPTIONS, 16,
                        MODIS_SZIP_BLOCK), 5, coded)


def write_modis_hdf4(folder, size=MODIS_SIZE, chunk=MODIS_CHUNK, seed=25, kind=5,
                     szip=MODIS_SZIP, name=None):
    """The tile as an HDF4 file in the SD API's layout: each set an NT,
    an SDD, a chunked SD of ``chunk``^2 chunks (special element ``kind``:
    5, the HDF4 library's, whose description record holds its length; 6,
    the JAX reader's layout without it) listed in an ``_HDF_CHK_TBL_``
    Vdata, each chunk a compressed special element (deflate at level 6;
    the reliability set's szip when ``szip``), an NDG, and a ``Var0.0``
    Vgroup with its long_name, units, _FillValue, scale_factor and
    add_offset; the StructMetadata.0 global attribute.  The chunks are
    coded in threads.  Returns (path, the stored sets)."""
    from concurrent.futures import ThreadPoolExecutor

    T = HDF4_TAGS
    sets = modis_fields(size, seed)
    grid = -(-size // chunk)
    objects, members, ref = [], [], 1
    jobs = []
    for index, values in enumerate(sets):
        padded = np.full((grid * chunk, grid * chunk), MODIS_FILL, np.int16)
        padded[:size, :size] = values
        coded_by_szip = szip and index == 2
        jobs += [(index, ci, cj, padded[ci * chunk:(ci + 1) * chunk, cj * chunk:(cj + 1) * chunk],
                  coded_by_szip) for ci in range(grid) for cj in range(grid)]
    with ThreadPoolExecutor(8) as pool:
        coded = list(pool.map(lambda job: modis_chunk(job[3], job[4]), jobs))
    chunks_of = {}
    for (index, ci, cj, block, _), (info, coder, data) in zip(jobs, coded):
        chunks_of.setdefault(index, []).append((ci, cj, block.nbytes, info, coder, data))
    for index, values in enumerate(sets):
        sds = ref
        objects.append((T["nt"], sds, bytes([1, 22, 16, 1])))  # int16, big-endian
        objects.append((T["sdd"], sds, struct.pack(">h2i", 2, size, size)
                        + struct.pack(">HH", T["nt"], sds) * 3))
        records = []
        ref += 1
        for ci, cj, nbytes, info, coder, data in chunks_of[index]:
            desc = struct.pack(">HHiHHH", 3, 0, nbytes, ref, 0, coder) + info
            objects.append((T["chunk"] | HDF4_SPECIAL, ref, desc))
            objects.append((T["compressed"], ref, data))
            records.append(struct.pack(">iiHH", ci, cj, T["chunk"], ref))
            ref += 1
        table = ref
        header, body = hdf4_vdata("_HDF_CHK_TBL_%d" % index, "_HDF_CHK_TBL_",
                                  [("origin", 24, 8, 2), ("chk_tag", 23, 2, 1),
                                   ("chk_ref", 23, 2, 1)], records)
        objects += [(T["vh"], table, header), (T["vs"], table, body)]
        ref += 1
        fill = np.array(MODIS_FILL, ">i2").tobytes()
        record = struct.pack(">BiiiiHHHHi", 0, 0, size * size * 2, chunk * chunk * 2, 2,
                             T["vh"], table, 1, 0, 2)
        record += struct.pack(">iii", 0, size, chunk) * 2 + struct.pack(">i", len(fill)) + fill
        lead = struct.pack(">Hi", 5, len(record)) if kind == 5 else struct.pack(">H", kind)
        objects.append((T["sd"] | HDF4_SPECIAL, sds, lead + record))
        objects.append((T["ndg"], sds, struct.pack(">4H", T["sdd"], sds, T["sd"], sds)))
        attributes = [(T["ndg"], sds)]
        for key, value in (("long_name", MODIS_SETS[index]),
                           ("units", "NDVI" if index == 0 else "EVI" if index == 1 else "rank"),
                           ("_FillValue", MODIS_FILL), ("scale_factor", MODIS_SCALE),
                           ("add_offset", 0.0)):
            header, body = hdf4_attribute(key, value)
            objects += [(T["vh"], ref, header), (T["vs"], ref, body)]
            attributes.append((T["vh"], ref))
            ref += 1
        objects.append((T["vg"], ref, hdf4_vgroup(MODIS_SETS[index], "Var0.0", attributes)))
        members.append((T["vg"], ref))
        ref += 1
    header, body = hdf4_attribute("StructMetadata.0", modis_struct_metadata(size))
    objects += [(T["vh"], ref, header), (T["vs"], ref, body)]
    members.append((T["vh"], ref))
    objects.append((T["vg"], ref + 1, hdf4_vgroup("MOD13Q1.hdf", "CDF0.0", members)))
    path = os.path.join(folder, name or "MOD13Q1.A2021193.%s.061.hdf" % MODIS_TILE)
    with open(path, "wb") as f:
        f.write(hdf4_bytes(objects))
    return path, sets


def modis_geo_transform(size=MODIS_SIZE):
    """The tile's GDAL geotransform, from its StructMetadata.0 corners."""
    (ulx, uly), (lrx, lry) = MODIS_UPPER_LEFT, MODIS_LOWER_RIGHT
    return (ulx, (lrx - ulx) / size, 0.0, uly, 0.0, (lry - uly) / size)


def build_modis_view(path):
    """Classify(Smooth(RasterFileSource(path), 500 m), NDVI bins): the
    vegetation classes of the smoothed index; the source's first frame,
    at MODIS_COMPOSITE, is NDVI."""
    from dask_geomodeling_tpu_torch import raster as port

    source = port.RasterFileSource(path, time_first=MODIS_COMPOSITE)
    return port.Classify(port.Smooth(source, MODIS_SMOOTH_M), MODIS_BINS)


def modis_request(size=MODIS_SIZE):
    """(a): the tile's own size^2 grid in its sinusoidal CRS, NDVI."""
    (ulx, uly), (lrx, lry) = MODIS_UPPER_LEFT, MODIS_LOWER_RIGHT
    return dict(mode="vals", projection=MODIS_PROJECTION, width=size, height=size,
                bbox=(ulx, lry, lrx, uly), start=MODIS_COMPOSITE, stop=MODIS_COMPOSITE)


def modis_rd_request(bbox=MODIS_RD_BBOX, cell=MODIS_RD_CELL):
    """(b): the Netherlands in RD New at ``cell`` m, NDVI."""
    x1, y1, x2, y2 = bbox
    return dict(mode="vals", projection="EPSG:28992", bbox=bbox,
                width=int(round((x2 - x1) / cell)), height=int(round((y2 - y1) / cell)),
                start=MODIS_COMPOSITE, stop=MODIS_COMPOSITE)


def hdf4_clock():
    """A PhaseClock over an HDF4 file's reads: whole reads and window
    reads."""
    from dask_geomodeling_tpu_torch.io import hdf4

    return PhaseClock([(hdf4, "read_hdf4", "whole reads"),
                       (hdf4, "read_hdf4_window", "window reads")])


class chunk_decodes:
    """The compressed elements (an HDF4 file's chunks) decoded while
    installed, in ``count``: they decode on the codec's thread pool, so a
    PhaseClock's nesting count would not hold."""

    def __enter__(self):
        from dask_geomodeling_tpu_torch.io import hdf4

        self.calls, self.original = [], hdf4._File._compressed

        def counted(file, desc):
            self.calls.append(None)  # list.append is atomic
            return self.original(file, desc)

        hdf4._File._compressed = counted
        return self

    @property
    def count(self):
        return len(self.calls)

    def __exit__(self, *exc):
        from dask_geomodeling_tpu_torch.io import hdf4

        hdf4._File._compressed = self.original
        return False


def chunks_touched(window, chunk=MODIS_CHUNK):
    """The chunks a (row0, row1, col0, col1) window touches."""
    row0, row1, col0, col1 = window
    return (-(-row1 // chunk) - row0 // chunk) * (-(-col1 // chunk) - col0 // chunk)


def check_modis_ndvi(card, device, folder, size=MODIS_SIZE, chunk=MODIS_CHUNK,
                     window_limit=MODIS_WINDOW_LIMIT, rd_bbox=MODIS_RD_BBOX,
                     sampled_tiles=MODIS_SAMPLED):
    """The modis-ndvi phase over a MOD13Q1-style tile (write_modis_hdf4:
    HDF4, chunked element kind 5, deflate chunks), build_modis_view under
    a geomodeling.windowed-read-limit of ``window_limit`` cells: ``info``
    from the header, no chunk decoded (hdf4_clock); (a) the tile's own
    grid (modis_request) through evaluate_tiled, its first run timed under
    the clock: every tile read by window, the chunks decoded those its
    window touches in each of the three sets, no whole
    read, the Gaussian once a batch (a batch a sigma) on float64 frames,
    its first launch torch.equal to its plain version; every tile of that
    run bitwise to compute_host; sampled windows equal to the matching
    slices of a whole read_hdf4, which holds the values written and the
    tile's sinusoidal georeference; (b) the Netherlands in RD New
    (modis_rd_request) with the checks of check_algebra_path, at most
    HEADLINE_SHARE of the cells off compute_host; malformed files raise
    the reader's ValueError.  Returns (launches, numbers); removes the
    files."""
    import torch

    from dask_geomodeling_tpu_torch import evaluate_tiled
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.io import hdf4
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    numbers = {}
    t0 = time.perf_counter()
    path, sets = write_modis_hdf4(folder, size, chunk)
    numbers["write_s"] = time.perf_counter() - t0
    numbers["file_mb"] = os.path.getsize(path) / 1e6
    grid = -(-size // chunk)
    print("modis-ndvi: %s, %d^2 cells of %.6f m in the MODIS sinusoidal grid, %d int16 sets in "
          "%d^2 chunks (%d a set, special element kind 5), deflate at level %d, %.1f MB written "
          "in %.2f s [%s]" % (MODIS_TILE, size, modis_geo_transform(size)[1], len(sets), chunk,
                              grid * grid, MODIS_DEFLATE_LEVEL, numbers["file_mb"],
                              numbers["write_s"], card))
    pipeline.clear_read_cache()
    launches = {"gaussian_blur": 0, "moving_max": 0}
    with config.set({"geomodeling.windowed-read-limit": window_limit}):
        view = build_modis_view(path)
        source = view.args[0].args[0]
        with hdf4_clock() as clock, chunk_decodes() as decodes:
            t0 = time.perf_counter()
            info = source.info
            numbers["info_s"] = time.perf_counter() - t0
        check(not any(clock.calls.values()) and decodes.count == 0,
              "modis-ndvi: info read %r and decoded %d chunks" % (clock.calls, decodes.count))
        got = (info.width, info.height, info.bands, info.dtype, info.projection,
               tuple(info.geo_transform), info.no_data_value, info.metadata)
        check(got == (size, size, 3, "float64", MODIS_PROJECTION, modis_geo_transform(size),
                      float(np.finfo(np.float32).max), list(MODIS_SETS)),
              "modis-ndvi: info %r" % (got,))
        print("modis-ndvi: info from the header in %.4f s, no chunk decoded: %d^2, %d bands "
              "%s, %s, geotransform %r, sets %s" % (numbers["info_s"], info.width, info.bands,
                                                    info.dtype, info.projection,
                                                    tuple(info.geo_transform), info.metadata))

        # (a) the tile's own grid, its first run under the clock
        request = modis_request(size)
        tiles, nx = tile_requests(request, TILE)
        windows = [source._file_read_plan(tile) for tile in tiles]
        check(all(plan is not None and plan[0] == 0 for plan in windows),
              "modis-ndvi: a tile is not read by window")
        touched = sum(chunks_touched(window, chunk) for _, window in windows) * len(sets)
        phases, spy = {}, gaussian_calls()
        cuda_stencils.reset_launches()
        batches = tile_runtime.batches_run
        with hdf4_clock() as clock, chunk_decodes() as decodes, spy:
            t0 = time.perf_counter()
            first = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                                   phase_seconds=phases)["values"]
            numbers["first_run_s"] = time.perf_counter() - t0
        # the Smooth's sigma differs in its last digits between tile
        # columns (the cells are not square in floating point): a batch
        # for each sigma
        batches = tile_runtime.batches_run - batches
        launches["gaussian_blur"] += cuda_stencils.launches
        check(clock.calls["whole reads"] == 0 and clock.calls["window reads"] == len(tiles)
              and decodes.count == touched,
              "modis-ndvi: the first run made %r decoding %d chunks, not %d window reads of %d "
              "chunks" % (clock.calls, decodes.count, len(tiles), touched))
        check(cuda_stencils.launches == batches == len(spy.calls) and batches < len(tiles),
              "modis-ndvi: %d Gaussian launches, %d calls for %d batches"
              % (cuda_stencils.launches, len(spy.calls), batches))
        planes, path_result, sigma, fill = spy.first
        check(planes.dtype == torch.float64, "modis-ndvi: the frames are %s" % planes.dtype)
        want = gaussian_blur_reference(planes, *sigma, fill)
        check(torch.equal(path_result, want), "gaussian_blur differs from its plain version on "
              "the modis-ndvi path's frames")
        err = float((path_result - want).abs().max())
        numbers["first_phases_s"] = phases
        numbers["read_s"] = clock.seconds["window reads"]
        print("modis-ndvi (a): first run %.3f s (%s), %d window reads decoding %d chunks on "
              "the codec's pool (%.3f s in the window reads), Gaussian %d launches on "
              "%s float64 sigma (%.4f, %.4f), the first torch.equal to its plain version "
              "(max_abs_err %r), %d batches [%s]" % (
                  numbers["first_run_s"], ", ".join("%s %.4f s" % kv for kv in phases.items()),
                  len(tiles), touched, numbers["read_s"],
                  cuda_stencils.launches, tuple(planes.shape), sigma[0], sigma[1], err, batches,
                  card))
        del planes, path_result, want, spy
        # every tile of the first run bitwise to compute_host, the last
        # first: the window cache holds the run's last 64 windows
        t0 = time.perf_counter()
        differing = 0
        for k in reversed(range(len(tiles))):
            tile = tiles[k]
            (rows, cols), (host_rows, host_cols) = tile_cells(k, nx, size, size, TILE)
            host = host_values(view, tile)[:, host_rows, host_cols]
            differing += int(np.count_nonzero(first[:, rows, cols] != host))
        numbers["host_s"] = time.perf_counter() - t0
        check(first.shape == (1, size, size) and differing == 0,
              "modis-ndvi (a): %r, %d cells differ from compute_host" % (first.shape, differing))
        print("modis-ndvi (a): every tile (%d) against compute_host (%.3f s): 0 of %d cells "
              "differ; classes %s" % (len(tiles), numbers["host_s"], first.size, np.bincount(
                  first.ravel(), minlength=len(MODIS_BINS) + 1).tolist()))
        del first

        # the windows against a whole read, which holds what was written
        t0 = time.perf_counter()
        whole = hdf4.read_hdf4(path)
        numbers["whole_read_s"] = time.perf_counter() - t0
        for band, stored in enumerate(sets):
            expected = np.where(stored == MODIS_FILL, np.finfo(np.float32).max,
                                MODIS_SCALE * (stored.astype(np.float64) - 0.0))
            check(np.array_equal(whole.array[band], expected),
                  "modis-ndvi: the whole read's %s differs from the values written"
                  % MODIS_SETS[band])
        check(whole.projection == MODIS_PROJECTION
              and tuple(whole.geo_transform) == modis_geo_transform(size),
              "modis-ndvi: the georeference %r %r" % (whole.projection, whole.geo_transform))
        rng = np.random.RandomState(26)
        for _ in range(4):
            row0, col0 = rng.randint(0, size - 1, 2)
            row1, col1 = row0 + rng.randint(1, 700), col0 + rng.randint(1, 700)
            part = hdf4.read_hdf4_window(path, row0, row1, col0, col1)
            check(np.array_equal(part.array, whole.array[:, row0:row1, col0:col1]),
                  "modis-ndvi: the window %r differs from the whole read"
                  % ((row0, row1, col0, col1),))
        del whole
        print("modis-ndvi: a whole read_hdf4 in %.3f s equals the values written (scale_factor "
              "%g, fill at the float32 maximum) and 4 sampled windows; %s and the h18v03 "
              "geotransform" % (numbers["whole_read_s"], MODIS_SCALE, MODIS_PROJECTION))

        # (b) the Netherlands in RD New
        rd_request = modis_rd_request(rd_bbox)
        cuda_stencils.reset_launches()
        t0 = time.perf_counter()
        numbers["rd_host_mpx_per_s"], _ = check_algebra_path(
            "modis-ndvi (b) RD", device, view, rd_request, "nearest",
            (rd_request["bbox"][0], rd_request["bbox"][3]), share=HEADLINE_SHARE,
            sigma_groups=True, sampled_tiles=sampled_tiles, routed=False)
        numbers["rd_s"] = time.perf_counter() - t0
        check(cuda_stencils.launches > 0, "modis-ndvi (b): the Gaussian did not launch")
        launches["gaussian_blur"] += cuda_stencils.launches

    # malformed files: the reader's ValueError
    errors = []
    with open(path, "rb") as f:
        head = f.read(4096)
    for name, body in (("truncated.hdf", head), ("empty.hdf", HDF4_MAGIC + bytes(64))):
        bad = os.path.join(folder, name)
        with open(bad, "wb") as f:
            f.write(body)
        try:
            RasterFileSource(bad).info
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
        os.remove(bad)
    check(errors[0] is not None and errors[0].startswith("Corrupt or truncated HDF4 file")
          and errors[1] is not None and errors[1].startswith("HDF4 file contains no 2-D/3-D"),
          "modis-ndvi: malformed files raised %r" % errors)
    print("modis-ndvi: a truncated and an empty HDF4 file raised ValueError: %s" % "; ".join(
        errors))
    os.remove(path)
    pipeline.clear_read_cache()
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("modis-ndvi: Gaussian %d launches on the path; the phase %.2f s [%s]"
          % (launches["gaussian_blur"], numbers["phase_s"], card))
    return launches, numbers


#: the grib-forecast path (the cookbook's recipe 1): 48 hourly rain fields
#: in the style of a convective regional model's 0.02 degree regular
#: lat-lon output, on a grid the size of DWD's ICON-D2 regular-lat-lon
#: domain (1215 x 746 points, 43.18-58.08 N, 3.94 W-20.34 E), as GRIB2:
#: template 3.0 with scanning mode 0, each field APCP under product
#: template 4.8; the first half in simple packing (5.0), the second in
#: complex packing with second-order spatial differencing (5.3)
GRIB_NI = 1215
GRIB_NJ = 746
GRIB_HOURS = 48
#: the first (north-west) grid point and the step in micro-degrees; the
#: longitude east of Greenwich, as producers store a grid that starts west
#: of it (356.06 is 3.94 W)
GRIB_LA1 = 58080000
GRIB_LO1 = 356060000
GRIB_STEP = 20000
GRIB_CENTRE = 78  # Offenbach (DWD)
GRIB_RUN = datetime(2024, 7, 14)  # the run's reference time: field k is hours k to k + 1
GRIB_D = 1  # 0.1 mm steps
GRIB_SMOOTH_M = 3000.0
GRIB_BINS = [0.1, 1.0, 5.0, 10.0, 25.0]  # recipe 1's bins and 25 mm
GRIB_AGGREGATE = "3h"
#: (b): recipe 1's bbox in RD New at 100 m over the first GRIB_RD_HOURS;
#: to_cog at the recipe's own 560 x 640 (500 m)
GRIB_RD_BBOX = (0.0, 300000.0, 280000.0, 620000.0)
GRIB_RD_CELL = 100.0
GRIB_COG_CELL = 500.0
GRIB_RD_HOURS = 24
GRIB_SAMPLED = 8
#: complex packing's groups: GRIB_GROUP points at least, up to
#: GRIB_GROUP_MAX, drawn at random
GRIB_GROUP = 10
GRIB_GROUP_MAX = 60
#: recipe 8's edition-1 archive: a 6-hour rain forecast of 250 x 200
#: points of 0.02 degree over GRIB1_BBOX, the BDS reference an IBM float
GRIB1_BBOX = (3.0, 50.0, 8.0, 54.0)
GRIB1_SHAPE = (200, 250)
GRIB1_REFERENCE = 3.75  # in 0.1 mm (D = 1)
GRIB1_MASK_BELOW = 1.0


def grib_sm(value, n):
    """GRIB's sign-magnitude ``value`` in ``n`` octets."""
    sign = 0
    if value < 0:
        sign, value = 1 << (8 * n - 1), -value
    return (int(value) | sign).to_bytes(n, "big")


def bit_lengths(values):
    """int.bit_length of each non-negative value below 2**32."""
    values = np.asarray(values, np.int64)
    lengths = np.zeros(values.shape, np.int64)
    for bit in range(32):
        lengths += (values >> bit) > 0
    return lengths


def pack_bits(values, widths):
    """The big-endian bitstream of non-negative ``values`` below 2**32 in
    ``widths`` bits each (an array, or one width for all), padded to whole
    octets.  One width: 8 values fill ``widths`` octets, each shifted into
    the fixed octets that hold it; several: each value of a width above 0
    shifted into the 5 octets from its first one, the octets summed in
    place (the values share no bit)."""
    values = np.asarray(values, np.int64).ravel()
    if np.ndim(widths) == 0:
        nbits = int(widths)
        if nbits == 0 or values.size == 0:
            return b""
        rows = -(-values.size // 8)
        cells = np.zeros(rows * 8, np.uint64)
        cells[: values.size] = values
        cells = cells.reshape(rows, 8)
        octets = np.zeros((rows, nbits), np.uint64)
        for k in range(8):
            first, shift = divmod(k * nbits, 8)
            span = (shift + nbits + 7) // 8
            placed = cells[:, k] << np.uint64(8 * span - shift - nbits)
            for j in range(span):
                octets[:, first + j] |= (placed >> np.uint64(8 * (span - 1 - j))) & np.uint64(0xFF)
        return octets.astype(np.uint8).tobytes()[: -(-values.size * nbits // 8)]
    widths = np.asarray(widths, np.int64).ravel()
    ends = np.cumsum(widths)
    total = int(ends[-1]) if ends.size else 0
    if total == 0:
        return b""
    keep = widths > 0
    starts, widths, values = (ends - widths)[keep], widths[keep], values[keep]
    first = starts >> 3
    window = values.astype(np.uint64) << (40 - (starts & 7) - widths).astype(np.uint64)
    octets = np.zeros(-(-total // 8) + 5, np.float64)
    for k in range(5):
        part = (window >> np.uint64(8 * (4 - k))) & np.uint64(0xFF)
        octets += np.bincount(first + k, weights=part.astype(np.float64), minlength=octets.size)
    return octets[: -(-total // 8)].astype(np.uint8).tobytes()


def grib_section(number, body):
    return struct.pack(">IB", len(body) + 5, number) + body


def grib2_message(sections, discipline=0):
    inner = b"".join(sections)
    return (b"GRIB" + bytes(2) + bytes([discipline, 2]) + struct.pack(">Q", 16 + len(inner) + 4)
            + inner + b"7777")


def grib_identification(reference):
    """Section 1: the centre, tables 2/1, the reference time as the start
    of the forecast, operational forecast products."""
    return grib_section(1, struct.pack(">HHBBB", GRIB_CENTRE, 255, 2, 1, 1) + struct.pack(
        ">HBBBBB", reference.year, reference.month, reference.day, reference.hour,
        reference.minute, reference.second) + bytes([0, 1]))


def grib_latlon_grid(ni, nj, la1=GRIB_LA1, lo1=GRIB_LO1, step=GRIB_STEP):
    """Section 3, template 3.0: ni x nj points of ``step`` micro-degrees
    from the north-west point (la1, lo1), scanning mode 0, on shape of
    earth 6 (the 6,371,229 m sphere)."""
    la2, lo2 = la1 - (nj - 1) * step, (lo1 + (ni - 1) * step) % 360000000
    template = (bytes([6]) + bytes(15) + struct.pack(">II", ni, nj) + bytes(8)
                + grib_sm(la1, 4) + grib_sm(lo1, 4) + bytes([0x30]) + grib_sm(la2, 4)
                + grib_sm(lo2, 4) + struct.pack(">II", step, step) + bytes([0]))
    return grib_section(3, struct.pack(">BIBBH", 0, ni * nj, 0, 0, 0) + template)


def grib_apcp_product(hour, reference):
    """Section 4, template 4.8: total precipitation (0, 1, 8) accumulated
    over the hour from ``hour`` at the surface."""
    end = reference + timedelta(hours=hour + 1)
    template = (struct.pack(">BBBBBHBB", 1, 8, 2, 0, 0, 0, 0, 1) + grib_sm(hour, 4)
                + struct.pack(">BBIBBI", 1, 255, 0xFFFFFFFF, 255, 255, 0xFFFFFFFF)
                + struct.pack(">HBBBBB", end.year, end.month, end.day, end.hour, end.minute,
                              end.second)
                + struct.pack(">BIBBBIBI", 1, 0, 1, 2, 1, 1, 255, 0))
    return grib_section(4, struct.pack(">HH", 0, 8) + template)


def grib_simple_field(stored, D=GRIB_D):
    """(section 5 in template 5.0, section 7) of the integers ``stored``:
    R 0, E 0, the fewest bits that hold the largest."""
    flat = np.asarray(stored, np.int64).ravel()
    nbits = int(flat.max()).bit_length()
    sec5 = grib_section(5, struct.pack(">IH", flat.size, 0) + struct.pack(">f", 0.0)
                        + grib_sm(0, 2) + grib_sm(D, 2) + bytes([nbits, 0]))
    return sec5, grib_section(7, pack_bits(flat, nbits))


def grib_c3_field(stored, rng, D=GRIB_D, nb=2):
    """(section 5 in template 5.3, section 7, number of groups) of the
    integers ``stored``, as wgrib2's ``c3`` repacking writes them: second
    order spatial differences (the first two values in the descriptors,
    two placeholders packed), in groups of GRIB_GROUP to GRIB_GROUP_MAX
    points each at its minimum and the fewest bits that hold its range."""
    flat = np.asarray(stored, np.int64).ravel()
    npts = flat.size
    second = flat[2:] - 2 * flat[1:-1] + flat[:-2]
    low = int(second.min()) if second.size else 0
    packed = np.concatenate([np.zeros(min(2, npts), np.int64), second - low])
    lengths = rng.integers(GRIB_GROUP, GRIB_GROUP_MAX + 1, npts // GRIB_GROUP + 1)
    ends = np.cumsum(lengths)
    count = int(np.searchsorted(ends, npts)) + 1
    lengths = lengths[:count].copy()
    lengths[-1] = npts - (int(ends[count - 2]) if count > 1 else 0)
    starts = np.cumsum(lengths) - lengths
    refs = np.minimum.reduceat(packed, starts)
    widths = bit_lengths(np.maximum.reduceat(packed, starts) - refs)
    scaled = np.maximum(lengths - GRIB_GROUP, 0)
    scaled[-1] = 0  # the last group's true length is its own octets
    nbits, width_bits, length_bits = (int(v.max()).bit_length() for v in (refs, widths, scaled))
    group = np.repeat(np.arange(count), lengths)
    sec5 = grib_section(5, struct.pack(">IH", npts, 3) + struct.pack(">f", 0.0) + grib_sm(0, 2)
                        + grib_sm(D, 2) + bytes([nbits, 0, 1, 0]) + bytes(8)
                        + struct.pack(">IBBIBIB", count, 0, width_bits, GRIB_GROUP, 1,
                                      int(lengths[-1]), length_bits) + bytes([2, nb]))
    stream = b"".join([grib_sm(int(flat[0]), nb), grib_sm(int(flat[min(1, npts - 1)]), nb),
                       grib_sm(low, nb), pack_bits(refs, nbits), pack_bits(widths, width_bits),
                       pack_bits(scaled, length_bits),
                       pack_bits(packed - refs[group], widths[group])])
    return sec5, grib_section(7, stream), count


def forecast_rain(hours=GRIB_HOURS, ni=GRIB_NI, nj=GRIB_NJ, seed=31):
    """Hourly rain in 0.1 mm as stored integers (hours, nj, ni), rows north
    to south: shower cells of 4-20 points' radius that drift east-north-east
    at about 25 km an hour, grow and decay over 3-12 hours, with a little
    texture where it rains, over a dry domain (a cell below 0.1 mm is 0)."""
    rng = np.random.default_rng(seed)
    n = max(8, ni * nj // 12000)
    y0, x0 = rng.uniform(0, nj, n), rng.uniform(-ni / 4, ni, n)
    born, life = rng.uniform(-6, hours, n), rng.uniform(3, 12, n)
    peak, radius = rng.gamma(1.5, 40.0, n), rng.uniform(4, 20, n)
    vy, vx = rng.normal(-4, 2, n), rng.normal(12, 3, n)
    rain = np.zeros((hours, nj, ni), np.int64)
    for hour in range(hours):
        field = np.zeros((nj, ni))
        for k in np.flatnonzero((born <= hour) & (hour < born + life)):
            age = hour - born[k]
            cy, cx, r = y0[k] + vy[k] * age, x0[k] + vx[k] * age, radius[k]
            rows = np.arange(max(0, int(cy - 3 * r)), min(nj, int(cy + 3 * r) + 1))
            cols = np.arange(max(0, int(cx - 3 * r)), min(ni, int(cx + 3 * r) + 1))
            if rows.size and cols.size:
                d2 = (rows[:, None] - cy) ** 2 + (cols[None, :] - cx) ** 2
                amp = peak[k] * np.sin(np.pi * age / life[k])
                field[rows[:, None], cols[None, :]] += amp * np.exp(-d2 / (2 * r * r))
        wet = field >= 1.0
        rain[hour][wet] = np.floor(field[wet]).astype(np.int64) + rng.integers(0, 4, int(wet.sum()))
    return rain


def write_forecast_grib(folder, ni=GRIB_NI, nj=GRIB_NJ, hours=GRIB_HOURS, seed=31,
                        origin=(GRIB_LA1, GRIB_LO1), name="forecast.grib2"):
    """The forecast as GRIB2 (forecast_rain) on ni x nj points from
    ``origin`` (the north-west point's micro-degrees): one message an hour,
    the first half in simple packing, the second in complex packing with
    second-order spatial differencing (grib_c3_field), no bitmap.
    Returns (path, the stored integers, the complex fields' group counts)."""
    rain = forecast_rain(hours, ni, nj, seed)
    rng = np.random.default_rng(seed + 1)
    head = [grib_identification(GRIB_RUN), grib_latlon_grid(ni, nj, *origin)]
    groups = []
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        for hour in range(hours):
            if hour < hours // 2:
                sec5, sec7 = grib_simple_field(rain[hour])
            else:
                sec5, sec7, count = grib_c3_field(rain[hour], rng)
                groups.append(count)
            f.write(grib2_message(head + [grib_apcp_product(hour, GRIB_RUN), sec5,
                                          grib_section(6, bytes([255])), sec7]))
    return path, rain, groups


def grib_values(stored, D=GRIB_D):
    """What the reader gives for ``stored`` packed with R 0 and E 0:
    (R + X * 2**E) / 10**D in float64."""
    return (0.0 + stored.astype(np.float64) * (2.0 ** 0)) / (10.0 ** D)


def ibm_float(value):
    """``value`` as an IBM System/360 single-precision float (GRIB1's BDS
    reference)."""
    if value == 0:
        return bytes(4)
    sign = 0x80000000 if value < 0 else 0
    value, exponent = abs(float(value)), 64
    while value >= 1.0:
        value, exponent = value / 16.0, exponent + 1
    while value < 1.0 / 16.0:
        value, exponent = value * 16.0, exponent - 1
    mantissa = int(round(value * (1 << 24)))
    if mantissa == 1 << 24:
        mantissa, exponent = mantissa >> 4, exponent + 1
    return struct.pack(">I", sign | (exponent << 24) | mantissa)


def write_grib1_archive(folder, seed=33, name="archive.grb"):
    """Recipe 8's GRIB edition-1 archive: one message of a 6-hour rain
    forecast (APCP, P1 = 6 h) over GRIB1_BBOX on its 0.02 degree grid
    (forecast_rain summed over six hours), simple packing with D = 1, E = 0
    and the reference GRIB1_REFERENCE as an IBM float.  Returns (path, the
    values the reader gives: (R + X) * 10**-1)."""
    nj, ni = GRIB1_SHAPE
    x1, y1, x2, y2 = GRIB1_BBOX
    step = round((x2 - x1) / ni * 1e3)  # millidegrees
    stored = forecast_rain(6, ni, nj, seed).sum(axis=0).ravel()
    nbits = int(stored.max()).bit_length()
    pds = ((28).to_bytes(3, "big") + bytes([2, GRIB_CENTRE, 0, 255, 0x80, 61, 1])
           + (0).to_bytes(2, "big") + bytes([24, 7, 14, 0, 0, 1, 6, 0, 0]) + bytes(2)
           + bytes([0, 21, 0]) + grib_sm(1, 2))
    la1, lo1 = round(y2 * 1e3) - step // 2, round(x1 * 1e3) + step // 2
    la2, lo2 = la1 - (nj - 1) * step, lo1 + (ni - 1) * step
    gds = ((32).to_bytes(3, "big") + bytes([0, 255, 0]) + struct.pack(">HH", ni, nj)
           + grib_sm(la1, 3) + grib_sm(lo1, 3) + bytes([0x80]) + grib_sm(la2, 3)
           + grib_sm(lo2, 3) + struct.pack(">HH", step, step) + bytes([0]) + bytes(4))
    packed = pack_bits(stored, nbits)
    bds = bytearray(bytes(3) + bytes([(8 - stored.size * nbits % 8) % 8]) + grib_sm(0, 2)
                    + ibm_float(GRIB1_REFERENCE) + bytes([nbits]) + packed)
    if len(bds) % 2:
        bds += b"\x00"
    bds[0:3] = len(bds).to_bytes(3, "big")
    inner = pds + gds + bytes(bds)
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        f.write(b"GRIB" + (8 + len(inner) + 4).to_bytes(3, "big") + bytes([1]) + inner + b"7777")
    values = (GRIB1_REFERENCE + stored.astype(np.float64) * 2.0 ** 0) * 10.0 ** -1
    return path, values.reshape(nj, ni)


def build_grib_view(path):
    """Classify(Smooth(TemporalAggregate(RasterFileSource(path), 3h, sum),
    3 km), recipe 1's bins and 25 mm): the classes of the smoothed
    three-hour rain sums; the source's frames an hour apart from
    GRIB_RUN."""
    from dask_geomodeling_tpu_torch import raster as port

    source = port.RasterFileSource(path, time_first=GRIB_RUN, time_delta=timedelta(hours=1))
    sums = port.TemporalAggregate(source, GRIB_AGGREGATE, statistic="sum")
    return port.Classify(port.Smooth(sums, GRIB_SMOOTH_M), GRIB_BINS)


def grib_request(geo_transform, ni=GRIB_NI, nj=GRIB_NJ, hours=GRIB_HOURS):
    """(a): the file's own ni x nj grid in EPSG:4326 over its ``hours``."""
    x0, dx, _, y0, _, dy = geo_transform
    return dict(mode="vals", projection="EPSG:4326", width=ni, height=nj,
                bbox=(x0, y0 + nj * dy, x0 + ni * dx, y0), start=GRIB_RUN,
                stop=GRIB_RUN + timedelta(hours=hours - 1))


def grib_rd_request(bbox=GRIB_RD_BBOX, cell=GRIB_RD_CELL, hours=GRIB_RD_HOURS):
    """(b): recipe 1's bbox in RD New at ``cell`` m over the first
    ``hours``."""
    x1, y1, x2, y2 = bbox
    return dict(mode="vals", projection="EPSG:28992", bbox=bbox,
                width=int(round((x2 - x1) / cell)), height=int(round((y2 - y1) / cell)),
                start=GRIB_RUN, stop=GRIB_RUN + timedelta(hours=hours - 1))


def grib_clock():
    """A PhaseClock over a GRIB file's whole reads and the fields they
    decode, by packing."""
    from dask_geomodeling_tpu_torch.io import grib

    return PhaseClock([(grib, "read_grib", "whole reads"),
                       (grib, "_decode_simple", "simple fields"),
                       (grib, "_decode_complex_diff", "complex fields")])


def grib_refusals(folder, path):
    """The errors that malformed copies of the forecast's first message
    raise through RasterFileSource.info: truncated (ValueError), its first
    section's length zeroed (ValueError), and a one-message file in
    template 5.40 (NotImplementedError naming io/grib.py)."""
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    with open(path, "rb") as f:
        head = f.read(16)
        first = head + f.read(struct.unpack(">Q", head[8:16])[0] - 16)
    broken = bytearray(first)
    struct.pack_into(">I", broken, 16, 0)
    values = (np.arange(24) % 7).reshape(4, 6)
    jpeg2000 = grib2_message([
        grib_identification(GRIB_RUN), grib_latlon_grid(6, 4), grib_apcp_product(0, GRIB_RUN),
        grib_section(5, struct.pack(">IH", 24, 40) + struct.pack(">f", 0.0) + grib_sm(0, 2)
                     + grib_sm(GRIB_D, 2) + bytes([3, 0, 0, 255])),
        grib_section(6, bytes([255])), grib_section(7, pack_bits(values, 3))])
    raised = []
    for name, body in (("truncated.grib2", first[: len(first) // 2]),
                       ("broken.grib2", bytes(broken)), ("jpeg2000.grib2", jpeg2000)):
        bad = os.path.join(folder, name)
        with open(bad, "wb") as f:
            f.write(body)
        try:
            RasterFileSource(bad).info
            raised.append(None)
        except (ValueError, NotImplementedError) as e:
            raised.append(e)
        os.remove(bad)
    return raised


def check_grib_forecast(card, device, folder, ni=GRIB_NI, nj=GRIB_NJ, hours=GRIB_HOURS,
                        origin=(GRIB_LA1, GRIB_LO1), rd_bbox=GRIB_RD_BBOX, rd_cell=GRIB_RD_CELL,
                        cog_cell=GRIB_COG_CELL, rd_hours=GRIB_RD_HOURS,
                        sampled_tiles=GRIB_SAMPLED):
    """The grib-forecast phase (recipe 1) over write_forecast_grib's file,
    build_grib_view: the whole read timed under grib_clock (info decodes
    the file once into the read cache, which every later read shares), held
    to the values written ((R + X 2**E) / 10**D) and to the grid's
    georeference (a west edge stored east of 180 degrees read west of
    Greenwich); mode "meta" one string a band,
    APCP at its forecast hour, equal to compute_host's; (a) the file's own
    grid over every hour (grib_request) through evaluate_tiled, its first
    run's phases timed, every tile bitwise to compute_host, the Gaussian on
    float64 frames once a batch (a batch a sigma), its first launch
    torch.equal to its plain version; (b) recipe 1's bbox in RD New at
    ``rd_cell`` over the first ``rd_hours`` (grib_rd_request) with the
    checks of check_algebra_path, at most HEADLINE_SHARE of the sampled
    cells off compute_host, its first launch torch.equal; to_cog at
    ``cog_cell`` read back equal to get_data; grib_refusals; recipe 8's
    GRIB1 archive under MaskBelow bitwise to compute_host.  Returns
    (launches, numbers, the Gaussian's records on up to BATCH planes of
    (a)'s and (b)'s first batches, timed where the frames are on the
    card); removes the files."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference, gaussian_weights
    from dask_geomodeling_tpu_torch.raster import MaskBelow, RasterFileSource, to_cog
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    numbers = {}
    t0 = time.perf_counter()
    path, rain, groups = write_forecast_grib(folder, ni, nj, hours, origin=origin)
    numbers["write_s"] = time.perf_counter() - t0
    numbers["file_mb"] = os.path.getsize(path) / 1e6
    numbers["groups"] = [min(groups), max(groups)]
    print("grib-forecast: %d hourly APCP fields of %d x %d points of 0.02 degree (%d simple, %d "
          "complex with second-order differencing in %d-%d groups), wet in %.4f of the cells, "
          "%.1f MB of GRIB2 written in %.2f s [%s]" % (
              hours, ni, nj, hours // 2, hours - hours // 2, min(groups), max(groups),
              float((rain > 0).mean()), numbers["file_mb"], numbers["write_s"], card))
    pipeline.clear_read_cache()
    view = build_grib_view(path)
    source = view.args[0].args[0].args[0]

    # the whole read: info decodes the file into the read cache
    with grib_clock() as clock:
        t0 = time.perf_counter()
        info = source.info
        numbers["read_s"] = time.perf_counter() - t0
    numbers["read_split_s"] = dict(clock.seconds)
    check(clock.calls == {"whole reads": 1, "simple fields": hours // 2,
                          "complex fields": hours - hours // 2},
          "grib-forecast: info made %r" % clock.calls)
    whole = pipeline.read_geotiff_cached(path)
    check(whole.array.shape == (hours, nj, ni) and whole.array.dtype == np.float64
          and all(np.array_equal(whole.array[hour], grib_values(rain[hour]))
                  for hour in range(hours)),
          "grib-forecast: the whole read differs from the values written")
    x0, dx, _, y0, _, dy = whole.geo_transform
    west = (origin[1] * 1e-6 + 180.0) % 360.0 - 180.0 - GRIB_STEP * 0.5e-6
    check(whole.projection == "EPSG:4326" and abs(x0 - west) < 1e-9
          and abs(dx - GRIB_STEP * 1e-6) < 1e-12
          and abs(y0 - (origin[0] + GRIB_STEP * 0.5) * 1e-6) < 1e-9
          and abs(dy + GRIB_STEP * 1e-6) < 1e-12
          and (info.width, info.height, info.bands) == (ni, nj, hours),
          "grib-forecast: georeference %r %r" % (whole.projection, whole.geo_transform))
    print("grib-forecast: the whole read (info) %.3f s: %s; equal to the values written; "
          "EPSG:4326, west edge %.6f, cells %.6f [%s]" % (
              numbers["read_s"], ", ".join("%s %.3f s" % kv for kv in clock.seconds.items()),
              x0, dx, card))
    meta_request = dict(mode="meta", start=GRIB_RUN, stop=GRIB_RUN + timedelta(hours=hours - 1))
    meta = get_data(source, device=device, **meta_request)["meta"]
    check(meta == compute_host(*source.get_compute_graph(**meta_request))["meta"]
          and len(meta) == hours
          and all("element=APCP" in m and " forecastTime=+%dh " % k in m
                  for k, m in enumerate(meta)),
          "grib-forecast: meta %r" % meta[:2])

    # (a) the file's own grid over every hour
    request = grib_request(whole.geo_transform, ni, nj, hours)
    del whole
    tiles, nx = tile_requests(request, TILE)
    phases, spy = {}, gaussian_calls()
    cuda_stencils.reset_launches()
    batches = tile_runtime.batches_run
    with spy:
        t0 = time.perf_counter()
        first = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                               phase_seconds=phases)["values"]
        numbers["first_run_s"] = time.perf_counter() - t0
    batches = tile_runtime.batches_run - batches
    launches_a = cuda_stencils.launches
    check(len(spy.calls) == batches <= len(tiles) and launches_a in (batches, 2 * batches),
          "grib-forecast (a): %d Gaussian launches, %d calls for %d batches of %d tiles"
          % (launches_a, len(spy.calls), batches, len(tiles)))
    planes_a, result, sigma_a, fill = spy.first
    check(planes_a.dtype == torch.float64, "grib-forecast: the frames are %s" % planes_a.dtype)
    want = gaussian_blur_reference(planes_a, *sigma_a, fill)
    check(torch.equal(result, want), "gaussian_blur differs from its plain version on the "
          "grib-forecast path's frames (a)")
    err_a = float((result - want).abs().max())
    del result, want
    numbers["first_phases_s"] = phases
    numbers["batches_a"] = batches
    print("grib-forecast (a): %d tiles over %d hours into %d sums, first run %.3f s (%s), "
          "Gaussian %d launches in %d batches (a batch a sigma: %s), first on %s float64, "
          "torch.equal to its plain version [%s]" % (
              len(tiles), hours, first.shape[0], numbers["first_run_s"],
              ", ".join("%s %.4f s" % kv for kv in phases.items()), launches_a, batches,
              ", ".join("(%.4f, %.4f)" % call[2] for call in spy.calls),
              tuple(planes_a.shape), card))
    t0 = time.perf_counter()
    differing = 0
    for k, tile in enumerate(tiles):
        (rows, cols), (host_rows, host_cols) = tile_cells(k, nx, ni, nj, TILE)
        host = host_values(view, tile)[:, host_rows, host_cols]
        differing += int(np.count_nonzero(first[:, rows, cols] != host))
    numbers["host_s"] = time.perf_counter() - t0
    check(first.shape == (hours // 3, nj, ni) and differing == 0,
          "grib-forecast (a): %r, %d cells differ from compute_host" % (first.shape, differing))
    print("grib-forecast (a): every tile (%d) against compute_host (%.3f s): 0 of %d cells "
          "differ; classes %s" % (len(tiles), numbers["host_s"], first.size, np.bincount(
              first.ravel(), minlength=len(GRIB_BINS) + 1).tolist()))
    del first

    # (b) recipe 1 in RD New
    rd_request = grib_rd_request(rd_bbox, rd_cell, rd_hours)
    sigma = smooth_sigma(view, tile_requests(rd_request, TILE)[0][0])
    per_call = 1 if max(gaussian_weights(s)[1] for s in sigma) <= 8 else 2
    cuda_stencils.reset_launches()
    phases_b, spy_b = {}, gaussian_calls()
    t0 = time.perf_counter()
    numbers["rd_host_mpx_per_s"], _ = check_algebra_path(
        "grib-forecast (b) RD", device, view, rd_request, "nearest", (rd_bbox[0], rd_bbox[3]),
        share=HEADLINE_SHARE, sampled_tiles=sampled_tiles, first_run=(spy_b, phases_b),
        routed=False, gaussian_launches=per_call)
    numbers["rd_s"] = time.perf_counter() - t0
    numbers["rd_phases_s"] = phases_b
    launches_b = cuda_stencils.launches
    check(launches_b > 0, "grib-forecast (b): the Gaussian did not launch")
    planes_b, result, sigma_b, fill = spy_b.first
    want = gaussian_blur_reference(planes_b, *sigma_b, fill)
    check(planes_b.dtype == torch.float64 and torch.equal(result, want),
          "gaussian_blur differs from its plain version on the grib-forecast path's frames (b)")
    err_b = float((result - want).abs().max())
    del result, want
    print("grib-forecast (b): %dx%d in RD New at %g m over %d hours, %.3f s, Gaussian %d "
          "launches on %s float64 sigma (%.4f, %.4f), torch.equal to its plain version [%s]" % (
              rd_request["width"], rd_request["height"], rd_cell, rd_hours, numbers["rd_s"],
              launches_b, tuple(planes_b.shape), sigma_b[0], sigma_b[1], card))

    # recipe 1's to_cog, read back
    cog_request = grib_rd_request(rd_bbox, cog_cell, rd_hours)
    target = os.path.join(folder, "classified.tif")
    t0 = time.perf_counter()
    to_cog(view, target, device=device, **{k: v for k, v in cog_request.items() if k != "mode"})
    numbers["cog_s"] = time.perf_counter() - t0
    back = read_geotiff(target)
    answer = get_data(view, device=device, **cog_request)
    check(back.array.dtype == answer["values"].dtype
          and np.array_equal(back.array, answer["values"])
          and back.no_data_value == answer["no_data_value"],
          "grib-forecast: the COG read back differs from get_data")
    os.remove(target)
    print("grib-forecast: to_cog at %dx%d (%g m) in %.3f s, read back equal to get_data"
          % (cog_request["width"], cog_request["height"], cog_cell, numbers["cog_s"]))
    pipeline.clear_read_cache()

    # the refusals and recipe 8's GRIB1 archive
    t0 = time.perf_counter()
    truncated, broken, jpeg2000 = grib_refusals(folder, path)
    check(isinstance(truncated, ValueError) and isinstance(broken, ValueError)
          and str(broken).startswith("Corrupt GRIB section header")
          and isinstance(jpeg2000, NotImplementedError) and "io/grib.py" in str(jpeg2000),
          "grib-forecast: malformed files raised %r" % [truncated, broken, jpeg2000])
    archive, archive_values = write_grib1_archive(folder)
    read = pipeline.read_geotiff_cached(archive)
    check(np.array_equal(read.array[0], archive_values),
          "grib-forecast: the GRIB1 archive differs from the values written")
    archive_source = RasterFileSource(archive)
    meta = archive_source.get_data(mode="meta", start=None, stop=None)["meta"][0]
    check("GRIB1" in meta and "element=APCP" in meta and "+6h" in meta,
          "grib-forecast: the archive's meta %r" % meta)
    wet = MaskBelow(archive_source, GRIB1_MASK_BELOW)
    (y_cells, x_cells), (x1, y1, x2, y2) = GRIB1_SHAPE, GRIB1_BBOX
    archive_request = dict(mode="vals", bbox=GRIB1_BBOX, projection="EPSG:4326",
                           width=x_cells, height=y_cells)
    card_wet = get_data(wet, device=device, **archive_request)
    host_wet = compute_host(*wet.get_compute_graph(**archive_request))
    check(card_wet["values"].dtype == host_wet["values"].dtype
          and np.array_equal(card_wet["values"], host_wet["values"])
          and card_wet["no_data_value"] == host_wet["no_data_value"]
          and 0 < np.count_nonzero(card_wet["values"] == card_wet["no_data_value"])
          < card_wet["values"].size,
          "grib-forecast: the GRIB1 archive under MaskBelow differs from compute_host")
    numbers["checks_s"] = time.perf_counter() - t0
    print("grib-forecast: a truncated message and a broken section length raised ValueError, "
          "template 5.40 NotImplementedError (%s); recipe 8's GRIB1 archive (%dx%d, IBM-float "
          "reference %g) equal to the values written, %s, under MaskBelow(%g) bitwise to "
          "compute_host (%.3f s)" % (str(jpeg2000)[:60], x_cells, y_cells, GRIB1_REFERENCE,
                                    meta, GRIB1_MASK_BELOW, numbers["checks_s"]))
    for name in (path, archive):
        os.remove(name)
    pipeline.clear_read_cache()

    # timed on at most BATCH planes of each batch: cuDNN's 73 x 73
    # convolution of (b)'s whole 336-plane batch would take seconds a call
    kernels = []
    if planes_a.is_cuda:
        kernels = [dict(time_gaussian(planes[:BATCH].contiguous(), sigma), max_abs_err=err,
                        path=label)
                   for label, planes, sigma, err in (
                       ("grib-forecast (a)", planes_a, sigma_a, err_a),
                       ("grib-forecast (b)", planes_b, sigma_b, err_b))]
    del planes_a, planes_b, spy, spy_b
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("grib-forecast: Gaussian %d launches on the path; the phase %.2f s [%s]"
          % (launches_a + launches_b, numbers["phase_s"], card))
    return ({"gaussian_blur": launches_a + launches_b,
             "moving_max": cuda_stencils.moving_max_launches}, numbers, kernels)


# the parcel-imagery phase: a commercial 4-band scene over Flevoland as
# NITF (WorldView/Pleiades-style: 11-bit values in 16-bit words, band
# interleaved by 1024^2 block, the corners outside the acquisition strip
# masked), the NDVI smoothed on the card and averaged per field parcel read
# from FlatGeobuf through its packed R-tree
SCENE_PX = 5120
SCENE_BLOCK = 1024
SCENE_BANDS = ("blue", "green", "red", "nir")
SCENE_WAVELENGTHS = ("480", "545", "660", "835")  # band centres, nm (ISUBCAT)
SCENE_ABPP = 11
#: the north-west pixel's centre and the arcseconds of longitude and
#: latitude to the other corners' centres: 10.0 x 10.2 km, about 2 m a
#: pixel, around 52.5 N, 5.5 E
SCENE_NORTH_WEST = ((52, 32, 45), (5, 25, 35))
SCENE_SPAN_S = (530, 330)
SCENE_FIELD_PX = 75  # the scene's fields, about 150 m
SCENE_TIME = datetime(2024, 6, 21, 10, 51, 12)  # the acquisition
SCENE_BAND_STEP = timedelta(seconds=1)  # band k is the frame k steps after SCENE_TIME
SCENE_SMOOTH_M = 15.0
SCENE_BINS = [0.2, 0.4, 0.6, 0.8]
#: (tile row from the north, tile column) of the 512^2 tiles held to
#: compute_host: the edges of both absent blocks, corners and the middle
SCENE_SAMPLED = ((0, 7), (0, 8), (1, 7), (2, 8), (2, 9), (1, 9), (7, 0), (7, 1), (8, 2), (9, 2),
                 (9, 1), (0, 0), (4, 4), (5, 6), (9, 9), (3, 2))
FIELD_GRID = 64
FIELD_CELL = 150.0
FIELD_ORIGIN = (157900.0, 506200.0)  # the fields' north-west corner, EPSG:28992
FIELD_CROPS = ("265", "259", "2014", "256", "233", "236")  # BRP crop codes
FIELD_CROP_P = (0.45, 0.2, 0.12, 0.1, 0.08, 0.05)
FIELD_MAX_PIXELS = 2**26  # the aggregation grid of the whole scene: about 42 Mpx
FIELD_EXPORT_TILE = 3500.0  # m in RD New: 3 x 3 tiles over the fields
#: the host's sub-area, (row, column) of its north-west and south-east
#: pixels: 600^2 pixels across the north-east absent block's corner
SCENE_SUB = ((724, 3796), (1323, 4395))


def nitf_field(value, n):
    """A NITF header field: ``value`` as ASCII, left-justified in ``n``."""
    text = str(value)
    if len(text) > n:
        raise ValueError("NITF field overflow: %r > %d" % (value, n))
    return text.ljust(n).encode("latin-1")


def nitf_number(value, n):
    return str(int(value)).rjust(n, "0").encode("latin-1")


def nitf_security(version, downgrade_event=False):
    """The security fields after a classification: 167 in NITF 2.1; in
    2.0 160 and FSDWNG, with FSDEVT after a downgrade of 999998."""
    if version == "2.1":
        return b" " * 167
    return b" " * 160 + (b"999998" + b" " * 40 if downgrade_event else b" " * 6)


def nitf_image_subheader(bands, nrows, ncols, version="2.1", pvtype="INT", nbpp=16, abpp=None,
                         irep="MULTI", icords="G", igeolo="", ic="NC", imode="B", nbpr=1, nbpc=1,
                         nppbh=None, nppbv=None, subcats=None, comments=0, xbands=False):
    """A NITF image subheader (MIL-STD-2500C's field layout): ``bands``
    bands of ``nrows`` x ``ncols`` in ``nbpr`` x ``nbpc`` blocks of
    ``nppbh`` x ``nppbv`` pixels; IGEOLO only where ICORDS names corners
    (in NITF 2.0, ICORDS N means none)."""
    subcats = subcats or [""] * bands
    body = bytearray(b"IM")
    body += nitf_field("SCENE", 10) + nitf_field(SCENE_TIME.strftime("%Y%m%d%H%M%S"), 14)
    body += nitf_field("", 17) + nitf_field("multispectral scene", 80) + b"U"
    body += nitf_security(version) + b"0" + nitf_field("synthetic", 42)
    body += nitf_number(nrows, 8) + nitf_number(ncols, 8) + nitf_field(pvtype, 3)
    body += nitf_field(irep, 8) + nitf_field("MS", 8) + nitf_number(abpp or nbpp, 2) + b"R"
    body += nitf_field(icords, 1)
    if icords.strip() and not (version == "2.0" and icords == "N"):
        body += nitf_field(igeolo, 60)
    body += nitf_number(comments, 1) + b" " * 80 * comments
    body += ic.encode("latin-1") + (b"" if ic in ("NC", "NM") else b"    ")  # COMRAT
    body += nitf_number(0, 1) + nitf_number(bands, 5) if xbands else nitf_number(bands, 1)
    for subcat in subcats:
        body += nitf_field("", 2) + nitf_field(subcat, 6) + b"N" + nitf_field("", 3)
        body += nitf_number(0, 1)  # NLUTS
    body += b"0" + nitf_field(imode, 1) + nitf_number(nbpr, 4) + nitf_number(nbpc, 4)
    body += nitf_number(nppbh or ncols, 4) + nitf_number(nppbv or nrows, 4)
    body += nitf_number(nbpp, 2) + nitf_number(1, 3) + nitf_number(0, 3)  # NBPP IDLVL IALVL
    body += nitf_field("0000000000", 10) + nitf_field("1.0 ", 4)  # ILOC, IMAG
    body += nitf_number(0, 5) + nitf_number(0, 5)  # UDIDL, IXSHDL
    return bytes(body)


def nitf_file_header(segments, version="2.1", downgrade_event=False):
    """A NITF file header for image segments of (subheader length, data
    length); FL and HL computed."""
    body = bytearray(b"NITF02.10" if version == "2.1" else b"NITF02.00")
    body += nitf_number(3, 2) + nitf_field("BF01", 4) + nitf_field("PARCELS", 10)
    body += nitf_field(SCENE_TIME.strftime("%Y%m%d%H%M%S"), 14) + nitf_field("scene", 80)
    body += b"U" + nitf_security(version, downgrade_event) + nitf_number(0, 5)
    body += nitf_number(1, 5) + b"0"  # FSCOP, FSCPYS, ENCRYP
    body += (bytes(3) + nitf_field("", 24)) if version == "2.1" else nitf_field("", 27)
    body += nitf_field("", 18)  # OPHONE
    fl_at = len(body)
    body += bytes(18) + nitf_number(len(segments), 3)
    for subheader_length, data_length in segments:
        body += nitf_number(subheader_length, 6) + nitf_number(data_length, 10)
    body += b"000" * 5 + b"00000" * 2  # NUMS..NUMRES, UDHDL, XHDL
    total = len(body) + sum(a + b for a, b in segments)
    body[fl_at : fl_at + 18] = nitf_number(total, 12) + nitf_number(len(body), 6)
    return bytes(body)


def nitf_block_mask(present, record_bytes, pad_code=b"\x00\x00"):
    """IC = NM's image data mask: the block offsets of the records in
    ``present`` order (absent ones 0xFFFFFFFF) after the pad pixel code."""
    offsets, at = [], 0
    for kept in present:
        offsets.append(at if kept else 0xFFFFFFFF)
        at += record_bytes if kept else 0
    head = 10 + len(pad_code) + 4 * len(offsets)
    return (struct.pack(">IHHH", head, 4, 0, 8 * len(pad_code)) + pad_code
            + struct.pack(">%dI" % len(offsets), *offsets))


def scene_igeolo():
    """ICORDS G corners of the scene, pixel centres UL, UR, LR, LL."""
    (lat_d, lat_m, lat_s), (lon_d, lon_m, lon_s) = SCENE_NORTH_WEST
    north, west = lat_d * 3600 + lat_m * 60 + lat_s, lon_d * 3600 + lon_m * 60 + lon_s
    south, east = north - SCENE_SPAN_S[1], west + SCENE_SPAN_S[0]

    def dms(seconds, width, hemisphere):
        d, rest = divmod(seconds, 3600)
        return "%0*d%02d%02d%s" % (width - 4, d, *divmod(rest, 60), hemisphere)

    return "".join(dms(lat, 6, "N") + dms(lon, 7, "E")
                   for lat, lon in ((north, west), (north, east), (south, east), (south, west)))


def scene_geo_transform(px=SCENE_PX):
    """The geotransform the corners give (cells between pixel centres,
    the corner half a cell out), as io/nitf.py computes it."""
    (lat_d, lat_m, lat_s), (lon_d, lon_m, lon_s) = SCENE_NORTH_WEST
    west = lon_d + lon_m / 60.0 + lon_s / 3600.0
    north = lat_d + lat_m / 60.0 + lat_s / 3600.0
    east = lon_d + lon_m / 60.0 + (lon_s + SCENE_SPAN_S[0]) / 3600.0
    south = lat_d + lat_m / 60.0 + (lat_s - SCENE_SPAN_S[1]) / 3600.0
    a, e = (east - west) / (px - 1), (south - north) / (px - 1)
    return (west - a / 2, a, 0.0, north - e / 2, 0.0, e)


def scene_bands(px=SCENE_PX, field_px=SCENE_FIELD_PX, seed=41):
    """(4, px, px) uint16 blue, green, red and near-infrared values in
    0-2047: fields of ``field_px`` pixels, each its own NDVI (0.05-0.85)
    and red level, with pixel noise."""
    rng = np.random.default_rng(seed)
    n = -(-px // field_px)
    cells = np.arange(px) // field_px
    ndvi = rng.uniform(0.05, 0.85, (n, n)).astype(np.float32)
    gain = (1 + ndvi) / (1 - ndvi)  # near-infrared over red
    red = rng.integers(150, 600, (n, n), dtype=np.uint16)[cells][:, cells]
    red += rng.integers(0, 64, (px, px), dtype=np.uint16)
    nir = np.minimum(red * gain[cells][:, cells], 2047).astype(np.uint16)
    blue = red // 2 + rng.integers(0, 32, (px, px), dtype=np.uint16)
    green = red - red // 4 + rng.integers(0, 32, (px, px), dtype=np.uint16)
    return np.stack([blue, green, red, nir])


def absent_blocks(n):
    """The blocks outside the acquisition strip of ``n`` x ``n`` blocks,
    (block row from the north, block column): the north-east and
    south-west corners."""
    return ((0, n - 1), (n - 1, 0))


def write_scene_nitf(folder, px=SCENE_PX, block=SCENE_BLOCK, seed=41, name="scene.ntf"):
    """scene_bands as a NITF 2.1 file: one segment, INT 16 bits of which
    11 significant, IREP MULTI, IMODE B in ``block``^2 blocks, IC = NM
    with absent_blocks masked out (pad pixel code 0), ICORDS G at
    scene_igeolo's corners.  Returns (path, the values a reader gives: the
    absent blocks 0)."""
    values = scene_bands(px, seed=seed)
    n = px // block
    absent = absent_blocks(n)
    present = [(r, c) not in absent for r in range(n) for c in range(n)]
    record = len(SCENE_BANDS) * block * block * 2
    mask = nitf_block_mask(present, record)
    subheader = nitf_image_subheader(
        len(SCENE_BANDS), px, px, abpp=SCENE_ABPP, igeolo=scene_igeolo(), ic="NM",
        nbpr=n, nbpc=n, nppbh=block, nppbv=block, subcats=SCENE_WAVELENGTHS)
    blocks = values.reshape(len(SCENE_BANDS), n, block, n, block).transpose(1, 3, 0, 2, 4)
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        f.write(nitf_file_header([(len(subheader), len(mask) + record * sum(present))]))
        f.write(subheader)
        f.write(mask)
        for k, kept in enumerate(present):
            if kept:
                f.write(np.ascontiguousarray(blocks[divmod(k, n)], dtype=">u2").data)
    for r, c in absent:
        values[:, r * block : (r + 1) * block, c * block : (c + 1) * block] = 0
    return path, values


def build_scene_view(path):
    """(Classify(smooth, bins), smooth) over the scene, smooth the NDVI
    smoothed over 15 m: the near-infrared band brought to the red band's
    time by Shift, the band sum masked below 1 (the absent blocks' pad)
    before the division, and the smoothed NDVI clipped to that sum's data
    (Smooth fills nodata with 0), so the absent blocks reach the answer as
    nodata."""
    from dask_geomodeling_tpu_torch import raster as port

    source = port.RasterFileSource(path, time_first=SCENE_TIME, time_delta=SCENE_BAND_STEP)
    red = source
    nir = port.Shift(source, -SCENE_BAND_STEP)
    total = port.MaskBelow(port.Add(nir, red), 1)
    ndvi = port.Divide(port.Subtract(nir, red), total)
    smooth = port.Clip(port.Smooth(ndvi, SCENE_SMOOTH_M), total)
    return port.Classify(smooth, SCENE_BINS), smooth


def scene_request(px=SCENE_PX):
    """The scene's own grid in EPSG:4326 at the red band's time."""
    x0, dx, _, y0, _, dy = scene_geo_transform(px)
    red_time = SCENE_TIME + 2 * SCENE_BAND_STEP
    return dict(mode="vals", projection="EPSG:4326", width=px, height=px,
                bbox=(x0, y0 + px * dy, x0 + px * dx, y0), start=red_time, stop=red_time)


def field_frame(grid=FIELD_GRID, cell=FIELD_CELL, origin=FIELD_ORIGIN, seed=43):
    """make_parcels' perturbed stars at ``cell`` m over ``grid``^2 cells
    from ``origin`` in RD New, as a frame: an integer id, a BRP crop code
    and the area in m^2."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import Polygon

    polygons, _ = make_parcels(grid, small=0, seed=seed, origin=origin, cell=cell)
    rng = np.random.default_rng(seed)
    geometries = [Polygon(p) for p in polygons]
    return GeoDataFrame({
        "id": np.arange(1, len(polygons) + 1),
        "crop": list(rng.choice(FIELD_CROPS, size=len(polygons), p=FIELD_CROP_P)),
        "area": np.array([g.area for g in geometries]),
    }, geometry=geometries, crs="EPSG:28992")


def field_views(parcels, smooth):
    """{statistic: AggregateRaster} of the smoothed NDVI per parcel, in
    EPSG:4326 at the scene's cell (the raster stays in its CRS)."""
    from dask_geomodeling_tpu_torch.geometry import AggregateRaster

    return {statistic: AggregateRaster(parcels, smooth, statistic, projection="EPSG:4326",
                                       max_pixels=FIELD_MAX_PIXELS, column_name="ndvi_" + statistic)
            for statistic in ("mean", "p90")}


def field_request(bbox):
    """mode "intersects" over ``bbox`` (EPSG:4326) at the red band's time."""
    from dask_geomodeling_tpu_torch.geo.geometry import box

    red_time = SCENE_TIME + 2 * SCENE_BAND_STEP
    return dict(mode="intersects", geometry=box(*bbox), projection="EPSG:4326",
                start=red_time, stop=red_time)


def pixel_box(geo_transform, north_west, south_east):
    """The EPSG:4326 bbox of the pixels from ``north_west`` to
    ``south_east`` ((row, column), inclusive)."""
    x0, dx, _, y0, _, dy = geo_transform
    (r1, c1), (r2, c2) = north_west, south_east
    return (x0 + c1 * dx, y0 + (r2 + 1) * dy, x0 + (c2 + 1) * dx, y0 + r1 * dy)


def by_id(features, column):
    """{id: the column's value} of an answer's features (indexed by id)."""
    return dict(zip(features.index.values.tolist(), features[column].values.tolist()))


def rows_equal(a, b):
    """Two rows of frame_rows equal, NaN equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (isinstance(a[k], float) and a[k] != a[k] and b[k] != b[k]) for k in a)


def fgb_clock():
    """A PhaseClock over a FlatGeobuf file's reads: the R-tree searches and
    the features decoded."""
    from dask_geomodeling_tpu_torch.io import flatgeobuf

    return PhaseClock([(flatgeobuf, "_search_packed_rtree", "R-tree search"),
                       (flatgeobuf, "_decode_properties", "features decoded")])


def scene_refusals(folder, device):
    """The errors the port raises, as the JAX package names them: a JPEG
    2000 (C8) segment's NotImplementedError naming io/nitf.py, through
    RasterFileSource.info; a truncated NITF's ValueError through the whole
    read; a FlatGeobuf of a bad magic's IOError through GeometryFileSource."""
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSource
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    small = (np.arange(64 * 64) % 2048).astype(">u2").tobytes()
    plain = nitf_image_subheader(1, 64, 64, irep="MONO", icords=" ")
    jp2 = nitf_image_subheader(1, 64, 64, irep="MONO", icords=" ", ic="C8")
    files = {
        "jp2.ntf": (nitf_file_header([(len(jp2), 4)]) + jp2 + b"\xff\x4f\xff\x51",
                     lambda p: RasterFileSource(p).info),
        "truncated.ntf": ((nitf_file_header([(len(plain), len(small))]) + plain
                           + small)[: -len(small) // 2], pipeline.read_geotiff_cached),
        "magic.fgb": (b"fgb\x02fgb\x00" + bytes(64), lambda p: GeometryFileSource(p).get_data(
            device=device, mode="intersects", geometry=box(0, 0, 1, 1),
            projection="EPSG:28992")),
    }
    raised = {}
    for name, (body, read) in files.items():
        path = os.path.join(folder, name)
        with open(path, "wb") as f:
            f.write(body)
        try:
            read(path)
            raised[name] = None
        except (ValueError, OSError, NotImplementedError) as e:
            raised[name] = e
        os.remove(path)
    return raised


def check_parcel_imagery(card, device, folder, px=SCENE_PX, block=SCENE_BLOCK,
                         sampled=SCENE_SAMPLED, grid=FIELD_GRID, cell=FIELD_CELL,
                         origin=FIELD_ORIGIN, sub=SCENE_SUB, export_tile=FIELD_EXPORT_TILE):
    """The parcel-imagery phase.  (a) write_scene_nitf's scene; info from
    the headers (uint16, 4 bands, the corners' geotransform), then the
    read cache's whole decode, timed by a PhaseClock over read_nitf,
    _unmask_blocks and _decode_blocks, equal to the values written, the
    absent blocks 0.  (b) build_scene_view at the
    scene's own grid in ``TILE``^2 tiles through evaluate_tiled, its first
    run's phases, the absent blocks nodata and only they, the ``sampled``
    tiles bitwise to compute_host, the Gaussian on float64 frames, its
    first launch torch.equal to its plain version.  (c) field_frame's
    parcels written as FlatGeobuf (node size 16) and as a GeoPackage;
    GeometryFileSource over the FlatGeobuf above a windowed-read limit of
    half its size, so that its R-tree answers; the mean and p90 of the
    smoothed NDVI per parcel over the whole scene on the card; both
    statistics over the ``sub`` pixels against compute_host (compare_zonal:
    mean within one float32 ulp, p90 bitwise) and the GeoPackage copy's
    answers there bitwise equal.  (d) to_file of the parcels with their
    mean in 3 x 3 tiles of ``export_tile`` m in RD New into FlatGeobuf
    partials merged into one, read back equal to the partials (geometries bitwise, fields equal, each
    parcel once), its R-tree search equal to a box filter.  (e)
    scene_refusals.  Returns (launches, numbers, the Gaussian's record on
    up to BATCH planes of (b)'s first batch where it ran on the card);
    removes its files."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, get_data
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSource
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import flatgeobuf, nitf, vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    numbers = {}
    t0 = time.perf_counter()
    path, values = write_scene_nitf(folder, px, block)
    numbers["nitf_write_s"] = time.perf_counter() - t0
    numbers["nitf_mb"] = os.path.getsize(path) / 1e6
    print("parcel-imagery: a %d^2 scene of %d bands (%s), 11 bits in 16, %d^2 blocks of which "
          "%d absent, %.1f MB of NITF written in %.2f s [%s]" % (
              px, len(SCENE_BANDS), "/".join(SCENE_BANDS), block,
              len(absent_blocks(px // block)),
              numbers["nitf_mb"], numbers["nitf_write_s"], card))
    pipeline.clear_read_cache()
    view, smooth = build_scene_view(path)
    source = smooth.args[1].args[0].args[1]

    # (a) info from the headers, then the whole read into the read cache
    t0 = time.perf_counter()
    info = source.info
    numbers["info_s"] = time.perf_counter() - t0
    geo_transform = scene_geo_transform(px)
    check(info.dtype == "uint16" and info.bands == 4 and (info.width, info.height) == (px, px)
          and info.projection == "EPSG:4326"
          and np.allclose(info.geo_transform, geo_transform, rtol=0, atol=1e-12),
          "parcel-imagery: info %r" % (info,))
    with PhaseClock([(nitf, "read_nitf", "whole read"), (nitf, "_unmask_blocks", "unmask"),
                     (nitf, "_decode_blocks", "decode")]) as clock:
        whole = pipeline.read_geotiff_cached(path)
    numbers["read_s"] = dict(clock.seconds)
    check(whole.array.dtype == np.uint16 and np.array_equal(whole.array, values),
          "parcel-imagery: the whole read differs from the values written")
    del values
    print("parcel-imagery (a): info from the headers in %.4f s (uint16, 4 bands, corners' "
          "geotransform); the whole read %s; equal to the values written, the absent blocks "
          "the pad code 0 [%s]" % (numbers["info_s"], ", ".join(
              "%s %.3f s" % kv for kv in clock.seconds.items()), card))

    # (b) the view at the scene's own grid
    request = scene_request(px)
    tiles, nx = tile_requests(request, TILE)
    phases, spy = {}, gaussian_calls()
    cuda_stencils.reset_launches()
    batches = tile_runtime.batches_run
    with spy:
        t0 = time.perf_counter()
        answer = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                                phase_seconds=phases)
        numbers["first_run_s"] = time.perf_counter() - t0
    batches = tile_runtime.batches_run - batches
    launches = cuda_stencils.launches  # (b)'s; (c) and (d) launch it too
    classes, nodata = answer["values"], answer["no_data_value"]
    check(len(spy.calls) == batches and launches in (batches, 2 * batches),
          "parcel-imagery (b): %d Gaussian launches, %d calls for %d batches"
          % (launches, len(spy.calls), batches))
    planes, result, sigma, fill = spy.first
    want = gaussian_blur_reference(planes, *sigma, fill)
    check(planes.dtype == torch.float64 and torch.equal(result, want),
          "gaussian_blur differs from its plain version on the parcel-imagery frames")
    err = float((result - want).abs().max())
    del result, want
    absent = np.zeros((px, px), bool)
    for r, c in absent_blocks(px // block):
        absent[r * block : (r + 1) * block, c * block : (c + 1) * block] = True
    check(classes.shape == (1, px, px) and np.array_equal(classes[0] == nodata, absent),
          "parcel-imagery (b): nodata is not exactly the absent blocks")
    numbers["first_phases_s"] = phases
    numbers["plan_share"] = phases.get("plan", 0.0) / numbers["first_run_s"]
    print("parcel-imagery (b): %d tiles in %d batches, first run %.3f s (%s; plan %.4f of it), "
          "Gaussian %d launches, first on %s float64 sigma (%.4f, %.4f), torch.equal to its "
          "plain version; nodata exactly on the absent blocks [%s]" % (
              len(tiles), batches, numbers["first_run_s"],
              ", ".join("%s %.4f s" % kv for kv in phases.items()), numbers["plan_share"],
              launches, tuple(planes.shape), sigma[0], sigma[1], card))
    t0 = time.perf_counter()
    differing = 0
    ny = len(tiles) // nx
    for north_row, column in sampled:
        index = (ny - 1 - north_row) * nx + column
        (rows, cols), (host_rows, host_cols) = tile_cells(index, nx, px, px, TILE)
        host = host_values(view, tiles[index])[:, host_rows, host_cols]
        differing += int(np.count_nonzero(classes[:, rows, cols] != host))
    numbers["host_s"] = time.perf_counter() - t0
    check(differing == 0, "parcel-imagery (b): %d cells differ from compute_host" % differing)
    print("parcel-imagery (b): %d sampled tiles (the absent blocks' edges among them) against "
          "compute_host (%.3f s): 0 cells differ; classes %s" % (
              len(sampled), numbers["host_s"],
              np.bincount(classes[classes != nodata], minlength=len(SCENE_BINS) + 1).tolist()))
    del classes, answer

    # (c) the parcels, from FlatGeobuf through its R-tree
    fields = field_frame(grid, cell, origin)
    fgb_path, gpkg_path = os.path.join(folder, "fields.fgb"), os.path.join(folder, "fields.gpkg")
    t0 = time.perf_counter()
    vectorfile.write_vector(fields, fgb_path)
    numbers["fgb_write_s"] = time.perf_counter() - t0
    vectorfile.write_vector(fields, gpkg_path)
    with open(fgb_path, "rb") as f:
        node_size = flatgeobuf.header_index_node_size(f.read(1 << 16))
    check(node_size == 16, "parcel-imagery: the FlatGeobuf's index node size is %r" % node_size)
    print("parcel-imagery (c): %d parcels of about %g m in RD New written as FlatGeobuf with its "
          "packed R-tree (node size 16, %.2f MB) in %.3f s" % (
              len(fields), cell, os.path.getsize(fgb_path) / 1e6, numbers["fgb_write_s"]))
    whole_box = pixel_box(geo_transform, (0, 0), (px - 1, px - 1))
    sub_box = pixel_box(geo_transform, *sub)
    numbers.update(zonal_s={}, rtree_s={}, features_decoded={})
    # geomodeling.vector-windowed-read-limit below the file: the R-tree answers
    with config.set({"geomodeling.vector-windowed-read-limit": os.path.getsize(fgb_path) // 2}):
        check(GeometryFileSource._fgb_above_limit(fgb_path),
              "parcel-imagery: the FlatGeobuf is not read through its R-tree")
        parcels = GeometryFileSource(fgb_path, id_field="id")
        for statistic, zonal in field_views(parcels, smooth).items():
            column = "ndvi_" + statistic
            with fgb_clock() as clock:
                t0 = time.perf_counter()
                features = get_data(zonal, device=device, **field_request(whole_box))["features"]
                seconds = time.perf_counter() - t0
            numbers["zonal_s"][statistic] = seconds
            numbers["rtree_s"][statistic] = clock.seconds["R-tree search"]
            numbers["features_decoded"][statistic] = clock.calls["features decoded"]
            values = features[column].values
            check(len(features) == len(fields) and np.isnan(values).any()
                  and np.isfinite(values).sum() > len(fields) // 2
                  and clock.calls["R-tree search"] >= 1,
                  "parcel-imagery: %s of %d parcels, %d R-tree searches" % (
                      statistic, len(features), clock.calls["R-tree search"]))
            print("parcel-imagery (c): the %s of %d parcels (%d with no data) on the card in "
                  "%.3f s; R-tree searches %d (%.4f s), features decoded %d" % (
                      statistic, len(features), int(np.isnan(values).sum()), seconds,
                      clock.calls["R-tree search"], clock.seconds["R-tree search"],
                      clock.calls["features decoded"]))
        # over the sub-area: against compute_host (both truths from one
        # graph), and the GeoPackage copy's answers bitwise
        views = {s: (v, field_request(sub_box)) for s, v in field_views(parcels, smooth).items()}
        t0 = time.perf_counter()
        hosts, _ = zonal_host_truths(views)
        numbers["zonal_host_s"] = time.perf_counter() - t0
        copies = field_views(GeometryFileSource(gpkg_path, id_field="id"), smooth)
        for statistic, (zonal, sub_request) in views.items():
            column = "ndvi_" + statistic
            port = get_data(zonal, device=device, **sub_request)
            differ, beyond, cells = compare_zonal(statistic, port, hosts[statistic], column)
            exact = statistic == "p90"
            check(beyond == 0 and (differ == 0 or not exact),
                  "parcel-imagery: %s differs from compute_host" % statistic)
            ours = by_id(port["features"], column)
            copy = by_id(get_data(copies[statistic], device=device, **sub_request)["features"],
                         column)
            check(sorted(ours) == sorted(copy) and np.array_equal(
                [ours[k] for k in sorted(ours)], [copy[k] for k in sorted(ours)], equal_nan=True),
                "parcel-imagery: the GeoPackage copy's %s differs" % statistic)
            print("parcel-imagery (c): %s over the sub-area (%d parcels, %d with no data) against "
                  "compute_host: %d differ, %d beyond one float32 ulp (%s); the GeoPackage "
                  "copy's bitwise equal" % (
                      statistic, cells, int(np.isnan(agg_matrix(port["features"], column)).sum()),
                      differ, beyond, "bitwise" if exact else "within one float32 ulp"))
        print("parcel-imagery (c): compute_host of the sub-area %.3f s" % numbers["zonal_host_s"])

        # (d) the export, in FlatGeobuf partials merged into one
        export = field_views(parcels, smooth)["mean"]
        target = os.path.join(folder, "ndvi.fgb")
        partials = []
        write_vector = vectorfile.write_vector

        def writing(frame, out, layer=None):
            if out != target:
                partials.append(frame)
            return write_vector(frame, out, layer)

        vectorfile.write_vector = writing
        try:
            t0 = time.perf_counter()
            to_file(export, target, fields={k: k for k in ("id", "crop", "area", "ndvi_mean")},
                    tile_size=export_tile, projection="EPSG:28992", mode="centroid",
                    device=device)
            numbers["export_s"] = time.perf_counter() - t0
        finally:
            vectorfile.write_vector = write_vector
    back = flatgeobuf.read_flatgeobuf(target)
    written = {}
    for frame in partials:
        written.update(frame_rows(frame.set_index("id")))
    read = frame_rows(back.set_index("id"))
    check(1 < len(partials) <= 9 and len(written) == sum(len(f) for f in partials)
          and sorted(read) == sorted(written) == list(range(1, len(fields) + 1))
          and all(rows_equal(read[k], written[k]) for k in read),
          "parcel-imagery (d): the merged FlatGeobuf differs from its %d partials" % len(partials))
    with open(target, "rb") as f:
        node_size = flatgeobuf.header_index_node_size(f.read(1 << 16))
    bounds = back.geometry.bounds
    searched = 0
    for k in range(4):
        x1, y1, x2, y2 = back.total_bounds
        box_k = (x1 + (x2 - x1) * k / 5, y1 + (y2 - y1) * k / 7, x1 + (x2 - x1) * (k + 2) / 5,
                 y1 + (y2 - y1) * (k + 1) / 4)
        hits = flatgeobuf.read_flatgeobuf(target, bbox=box_k)
        brute = np.flatnonzero(~((bounds["maxx"].values < box_k[0])
                                 | (bounds["minx"].values > box_k[2])
                                 | (bounds["maxy"].values < box_k[1])
                                 | (bounds["miny"].values > box_k[3])))
        check(node_size == 16 and hits.index.values.tolist() == brute.tolist(),
              "parcel-imagery (d): the R-tree search differs from a box filter")
        searched += len(hits)
    print("parcel-imagery (d): to_file in %d tiles of %g m into FlatGeobuf partials merged into "
          "one in %.3f s: %d parcels read back equal to the partials, each once; the R-tree "
          "search of 4 boxes (%d hits) equal to a box filter [%s]" % (
              len(partials), export_tile, numbers["export_s"], len(read), searched, card))

    # (e) the refusals
    raised = scene_refusals(folder, device)
    jp2, truncated, magic = raised["jp2.ntf"], raised["truncated.ntf"], raised["magic.fgb"]
    check(isinstance(jp2, NotImplementedError)
          and "dask_geomodeling_tpu/io/nitf.py" in str(jp2)
          and isinstance(truncated, ValueError) and str(truncated) == "NITF image data truncated"
          and isinstance(magic, OSError) and str(magic).startswith("Not a FlatGeobuf file"),
          "parcel-imagery: the refusals raised %r" % raised)
    print("parcel-imagery (e): a C8 segment raised NotImplementedError (%s); a truncated NITF "
          "ValueError(%r); a bad FlatGeobuf magic %s(%r)" % (
              str(jp2)[:48], str(truncated), type(magic).__name__, str(magic)[:22]))
    for name in (path, fgb_path, gpkg_path, target):
        os.remove(name)
    pipeline.clear_read_cache()

    # the path's launches, read before the kernel's timing launches it
    path_launches = {"gaussian_blur": cuda_stencils.launches,
                     "moving_max": cuda_stencils.moving_max_launches}
    kernels = []
    if planes.is_cuda:
        kernels = [dict(time_gaussian(planes[:BATCH].contiguous(), sigma), max_abs_err=err,
                        path="parcel-imagery")]
    del planes, spy
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("parcel-imagery: Gaussian %d launches on the path, %d of them in (b); the phase %.2f s "
          "[%s]" % (path_launches["gaussian_blur"], launches, numbers["phase_s"], card))
    return path_launches, numbers, kernels


#: the lzw-sheet phase: the sheet as a tiled LZW GeoTIFF (predictor 1: the
#: port, like the JAX reader, refuses the floating-point predictor 3) and
#: hfa-roughness' land use as a stripped PackBits GeoTIFF, both encoded by
#: chip_smoke_encoders.cpp; a host pool of
#: POOL_WORKERS local workers answers POOL_TILES sampled tiles
ENCODERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke_encoders.cpp")
LZW_TILE = 512
PACKBITS_ROWS = 8  # rows a strip: 64 KB strips of the 8000-wide land use
LZW_SAMPLED = 8
POOL_WORKERS = 2
POOL_TILES = 2
#: rows of a file tile the pure-Python decoder times, 64 KiB: its time
#: grows with the square of a stream's length (the bit accumulator is never
#: trimmed), so a whole 1 MiB tile takes minutes
PYTHON_ROWS = 32
#: struct code: SHORT, LONG, DOUBLE, ASCII, and "B": UNDEFINED bytes
_TIFF_TYPES = {"H": 3, "I": 4, "d": 12, "s": 2, "B": 7}


@functools.cache
def fixture_encoders():
    """chip_smoke_encoders.cpp built with g++ by the port's ops/_build.py
    (into its _build/, at first use) and loaded with ctypes, its
    signatures declared once."""
    import ctypes

    from dask_geomodeling_tpu_torch.ops import _build

    lib = _build.load_host_library(ENCODERS)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.lzw_encode.restype = ctypes.c_int64
    lib.lzw_encode.argtypes = [u8_p, ctypes.c_int64, u8_p, ctypes.c_int64]
    lib.packbits_encode_rows.restype = ctypes.c_int64
    lib.packbits_encode_rows.argtypes = [u8_p, ctypes.c_int64, ctypes.c_int64, u8_p,
                                         ctypes.c_int64]
    return lib


def lzw_encode(chunk):
    """One TIFF LZW chunk of the bytes of the C-contiguous array ``chunk``
    (libtiff's stream: see chip_smoke_encoders.cpp)."""
    import ctypes

    src = np.ascontiguousarray(chunk).reshape(-1).view(np.uint8)
    capacity = src.size * 3 // 2 + 64  # at most 12 bits a byte, and the codes around
    out = np.empty(capacity, np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    n = fixture_encoders().lzw_encode(src.ctypes.data_as(u8_p), src.size,
                                      out.ctypes.data_as(u8_p), capacity)
    check(n >= 0, "lzw_encode: the output outgrew %d bytes" % capacity)
    return out[:n].tobytes()


def packbits_encode(rows):
    """The PackBits chunk of the 2D uint8 array ``rows``, each row on its own."""
    import ctypes

    rows = np.ascontiguousarray(rows, np.uint8)
    capacity = 2 * rows.size + 16  # a literal byte between two repeats costs two
    out = np.empty(capacity, np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    n = fixture_encoders().packbits_encode_rows(rows.ctypes.data_as(u8_p), rows.shape[0],
                                                rows.shape[1], out.ctypes.data_as(u8_p),
                                                capacity)
    check(n >= 0, "packbits_encode: the output outgrew %d bytes" % capacity)
    return out[:n].tobytes()


def write_coded_tiff(path, values, geo_transform, projection, no_data_value, compression,
                     predictor=1, tile=None, rows_per_strip=None):
    """A classic little-endian single-band GeoTIFF of the 2D array
    ``values``, as GDAL lays one out: compression 5 (LZW, lzw_encode) or
    32773 (PackBits, packbits_encode) in tile^2 tiles (edge tiles padded
    with zeros) or in strips of rows_per_strip rows; ``predictor`` 2 stores
    each row's differences (integers, modulo their width); the georeference
    as the port's writer writes it (pixel scale, tiepoint, GeoKeys,
    GDAL_NODATA).  The chunks encode on the port's codec pool (the
    encoders release the GIL).  Returns the chunks' bytes in all."""
    from dask_geomodeling_tpu_torch.io.geotiff import _map_chunks

    height, width = values.shape
    if predictor == 2:
        stored = values.copy()
        np.subtract(values[:, 1:], values[:, :-1], out=stored[:, 1:])
    else:
        stored = values
    if tile is not None:
        pieces = []
        for row in range(0, height, tile):
            for col in range(0, width, tile):
                piece = np.zeros((tile, tile), values.dtype)
                sub = stored[row : row + tile, col : col + tile]
                piece[: sub.shape[0], : sub.shape[1]] = sub
                pieces.append(piece)
    else:
        pieces = [stored[row : row + rows_per_strip] for row in range(0, height, rows_per_strip)]
    encode = lzw_encode if compression == 5 else packbits_encode
    chunks = _map_chunks(encode, pieces)
    tags = [(256, "I", [width]), (257, "I", [height]),
            (258, "H", [values.dtype.itemsize * 8]), (259, "H", [compression]),
            (262, "H", [1]), (277, "H", [1]), (284, "H", [1]),
            (339, "H", [{"u": 1, "i": 2, "f": 3}[values.dtype.kind]]),
            (42113, "s", repr(float(no_data_value)))]
    if predictor != 1:
        tags.append((317, "H", [predictor]))
    if tile is not None:
        tags += [(322, "H", [tile]), (323, "H", [tile])]
    else:
        tags += [(278, "I", [rows_per_strip])]
    write_tiff_layout(path, tags, chunks, geo_transform, projection, tiled=tile is not None)
    return sum(len(c) for c in chunks)


def write_tiff_layout(path, tags, chunks, geo_transform, projection, tiled):
    """A classic little-endian TIFF of one IFD: ``tags`` ((tag, struct
    code of _TIFF_TYPES, values) without the chunk offsets and byte counts
    and the georeference, which this adds: pixel scale, tiepoint, GeoKeys
    as the port's writer writes them), the IFD's out-of-line values after
    it, then ``chunks`` (tiles when ``tiled``, else strips) in order."""
    from dask_geomodeling_tpu_torch.io.geotiff import _geokeys_for_projection

    geokeys, ascii_params = _geokeys_for_projection(projection)
    p, a, _, q, _, d = geo_transform
    n = len(chunks)
    tags = list(tags) + [(33550, "d", [abs(a), abs(d), 0.0]),
                         (33922, "d", [0.0, 0.0, 0.0, p, q, 0.0]), (34735, "H", geokeys)]
    if ascii_params:
        tags.append((34737, "s", ascii_params))
    offsets_tag, counts_tag = (324, 325) if tiled else (273, 279)
    tags += [(offsets_tag, "I", [0] * n), (counts_tag, "I", [len(c) for c in chunks])]
    tags.sort()
    ifd_size = 2 + 12 * len(tags) + 4

    def payload(kind, entry):
        if kind == "s":
            return entry.encode("ascii") + b"\0"
        if kind == "B":
            return bytes(entry)
        return struct.pack("<%d%s" % (len(entry), kind), *entry)

    extra_size = sum(-(-len(payload(kind, entry)) // 2) * 2 for _, kind, entry in tags
                     if len(payload(kind, entry)) > 4)
    data_start = 8 + ifd_size + extra_size
    offsets = list(np.cumsum([data_start] + [len(c) for c in chunks[:-1]]))
    ifd, extra = [struct.pack("<H", len(tags))], []
    at = 8 + ifd_size
    for tag, kind, entry in tags:
        if tag == offsets_tag:
            entry = [int(o) for o in offsets]
        blob = payload(kind, entry)
        count = len(blob) if kind in ("s", "B") else len(entry)
        if len(blob) <= 4:
            ifd.append(struct.pack("<HHI", tag, _TIFF_TYPES[kind], count) + blob.ljust(4, b"\0"))
        else:
            ifd.append(struct.pack("<HHII", tag, _TIFF_TYPES[kind], count, at))
            blob = blob.ljust(-(-len(blob) // 2) * 2, b"\0")
            extra.append(blob)
            at += len(blob)
    ifd.append(struct.pack("<I", 0))
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        f.write(b"".join(ifd))
        f.write(b"".join(extra))
        check(f.tell() == data_start, "write_tiff_layout: the layout is off")
        for chunk in chunks:
            f.write(chunk)


def write_lzw_sheet(folder, sheet, name="sheet_lzw.tif"):
    """The sheet at ``sheet`` (a GeoTIFF of write_sheet, read whole) as a
    tiled LZW GeoTIFF of LZW_TILE^2 tiles, predictor 1; returns (path,
    chunk bytes)."""
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff

    source = read_geotiff(sheet)
    path = os.path.join(folder, name)
    size = write_coded_tiff(path, source.array[0], source.geo_transform, source.projection,
                            source.no_data_value, 5, tile=LZW_TILE)
    return path, size


def write_lgn_packbits(folder, classes, name="lgn_packbits.tif"):
    """hfa-roughness' classes as a stripped PackBits GeoTIFF (PACKBITS_ROWS
    rows a strip, no predictor: libtiff's PackBits codec applies none, so
    GDAL writes and reads PackBits without one), nodata 0 as the .img's
    Eimg_NonInitializedValue, and lgn_rat(classes) as its PAM sidecar;
    returns (path, chunk bytes)."""
    from dask_geomodeling_tpu_torch.io.pam import write_raster_attribute_table

    path = os.path.join(folder, name)
    size = write_coded_tiff(path, classes, LGN_GEO_TRANSFORM, "EPSG:28992", 0, 32773,
                            rows_per_strip=PACKBITS_ROWS)
    write_raster_attribute_table(path, lgn_rat(classes))
    return path, size


class call_spy:
    """While installed, each (owner, attribute) wrapped: the calls, the
    seconds inside them summed over threads, and the most calls in flight
    at once, per attribute name; thread-safe."""

    def __init__(self, patches):
        self.patches = patches
        names = [attribute for _, attribute in patches]
        self.calls = dict.fromkeys(names, 0)
        self.seconds = dict.fromkeys(names, 0.0)
        self.most = dict.fromkeys(names, 0)
        self._active = dict.fromkeys(names, 0)
        self._lock = threading.Lock()
        self._saved = []

    def _wrap(self, func, name):
        def counted(*args, **kwargs):
            with self._lock:
                self._active[name] += 1
                self.most[name] = max(self.most[name], self._active[name])
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                with self._lock:
                    self._active[name] -= 1
                    self.calls[name] += 1
                    self.seconds[name] += time.perf_counter() - t0

        return counted

    def __enter__(self):
        for owner, attribute in self.patches:
            raw = getattr(owner, attribute)
            self._saved.append((owner, attribute, raw))
            setattr(owner, attribute, self._wrap(raw, attribute))
        return self

    def __exit__(self, *exc):
        for owner, attribute, raw in reversed(self._saved):
            setattr(owner, attribute, raw)
        self._saved = []
        return False


def native_spy():
    """A call_spy over the native TIFF decode and burn, the pure-Python
    decoders and the numpy polygon scanline."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.geo import rasterize
    from dask_geomodeling_tpu_torch.io import geotiff

    return call_spy([(native, "tiff_decode_native"), (native, "rasterize_native"),
                     (geotiff, "_lzw_decode"), (geotiff, "_packbits_decode"),
                     (rasterize, "_burn_polygon_rows")])


def check_native_only(label, spy):
    """No pure-Python decode and no numpy polygon scanline under ``spy``."""
    plain = {name: spy.calls[name]
             for name in ("_lzw_decode", "_packbits_decode", "_burn_polygon_rows")}
    check(not any(plain.values()), "%s: the plain versions ran on the path: %s" % (label, plain))


def spawn_host_workers(address, token, count):
    """``count`` port host workers (python -m
    dask_geomodeling_tpu_torch.parallel.hostworker) joining ``address``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return [subprocess.Popen([sys.executable, "-m",
                              "dask_geomodeling_tpu_torch.parallel.hostworker", address,
                              "--token", token], cwd=root, env=env, stdin=subprocess.DEVNULL)
            for _ in range(count)]


def stop_processes(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def check_lzw_sheet(card, device, folder, sheet, file_read, read_values, lgn,
                    sampled_tiles=LZW_SAMPLED, pool_workers=POOL_WORKERS):
    """The lzw-sheet phase: (a) the sheet at ``sheet`` written as a tiled
    LZW GeoTIFF (write_lzw_sheet), file-read's view and request over it
    with the checks of check_algebra_path (bitwise, no second get_data
    run), every cell equal to file-read's ``read_values``, every chunk
    decoded natively (their count, MB, MB/s over the decodes' summed
    seconds and the most decoded at once: a window's tiles on the codec's
    pool), none in Python; the central file tile's native decode timed,
    and its first PYTHON_ROWS rows as one stream by the pure-Python
    decoder, the same bytes; (b) ``lgn["classes"]`` (hfa-roughness') as a
    stripped PackBits GeoTIFF (write_lgn_packbits), hfa-roughness' chain at lgn_request with the
    checks of check_algebra_path, every cell equal to ``lgn["values"]``
    (hfa-roughness' answer; both taken out of ``lgn``), natively decoded;
    (d) a HostPool of ``pool_workers`` local worker processes (started as
    the phase begins): POOL_TILES of (a)'s sampled tiles' compute graphs
    through ``pool.scheduler`` equal to compute_host in this process, its
    /status.json read once; every worker stopped.  The first Gaussian of
    (a) and of (b) torch.equal to its plain version.  Returns (launches,
    numbers, the Gaussian's kernel records on the card); removes the
    files."""
    import secrets
    import urllib.request

    from dask_geomodeling_tpu_torch import compute_host, native
    from dask_geomodeling_tpu_torch.io.geotiff import _lzw_decode, _open_tiff
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.parallel import HostPool
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    phase_t0 = time.perf_counter()
    numbers, procs = {}, []
    token = secrets.token_hex(8)
    pool = HostPool(token=token, dashboard_port=0)
    try:
        procs += spawn_host_workers(pool.address, token, pool_workers)
        file_view, request, interpolation, corner = file_read
        tiles, _ = tile_requests(request, TILE)
        cuda_stencils.reset_launches()

        # (a) the LZW sheet
        t0 = time.perf_counter()
        path, size = write_lzw_sheet(folder, sheet)
        numbers["lzw_write_s"] = time.perf_counter() - t0
        numbers["lzw_mb"] = size / 1e6
        print("lzw-sheet (a): the sheet written as a tiled LZW GeoTIFF (%d^2 tiles, predictor "
              "1, chip_smoke_encoders.cpp) in %.2f s, %.1f MB of chunks (%.3f of the raw bytes) "
              "[%s]" % (LZW_TILE, numbers["lzw_write_s"], size / 1e6,
                        size / (4 * request["width"] * request["height"]), card))
        source = RasterFileSource(path)
        reference = file_view.store
        check((source.info.width, source.info.height, source.info.dtype, source.projection,
               source.info.no_data_value, tuple(source.geo_transform))
              == (reference.info.width, reference.info.height, reference.info.dtype,
                  reference.projection, reference.info.no_data_value,
                  tuple(reference.geo_transform)), "lzw-sheet (a): the header differs from the "
              "deflate sheet's")
        check(source._file_read_plan(request) is not None, "lzw-sheet (a): the read is not "
              "windowed")
        view = Smooth(source, 3)
        native.reset_counts()
        phases, gaussians = {}, gaussian_calls()
        with native_spy() as spy:
            host_rate, values = check_algebra_path(
                "lzw-sheet", device, view, request, interpolation, corner, share=0.0,
                sampled_tiles=sampled_tiles, first_run=(gaussians, phases), routed=False)
        decodes = dict(native.counts)
        check_native_only("lzw-sheet (a)", spy)
        check(decodes["tiff_decodes"] > 0 and spy.calls["tiff_decode_native"]
              == decodes["tiff_decodes"], "lzw-sheet (a): %r native decodes" % decodes)
        differ = int(np.count_nonzero(values != read_values))
        check(differ == 0, "lzw-sheet (a): %d cells differ from file-read" % differ)
        del values
        launches_a = cuda_stencils.launches
        check(launches_a > 0, "lzw-sheet (a): the Gaussian did not launch")
        seconds = spy.seconds["tiff_decode_native"]
        numbers.update(first_phases_s=phases, host_mpx_per_s=host_rate,
                       native_decodes=decodes["tiff_decodes"],
                       decoded_mb=decodes["tiff_bytes"] / 1e6, decode_s=seconds,
                       decode_mb_per_s=decodes["tiff_bytes"] / 1e6 / seconds,
                       most_decodes_at_once=spy.most["tiff_decode_native"])
        print("lzw-sheet (a): every cell equal to file-read's; %d native LZW decodes, %.1f MB in "
              "%.3f s summed over threads (%.1f MB/s a thread), at most %d at once; no Python "
              "decode; first run %s; Gaussian %d launches [%s]" % (
                  decodes["tiff_decodes"], numbers["decoded_mb"], seconds,
                  numbers["decode_mb_per_s"], numbers["most_decodes_at_once"],
                  ", ".join("%s %.4f s" % kv for kv in phases.items()), launches_a, card))
        timed = [plain_gaussian_check("lzw-sheet (a)", gaussians, gaussian_blur_reference)]

        # (b) the PackBits land use
        classes, expected = lgn.pop("classes"), lgn.pop("values")
        height, width = classes.shape
        t0 = time.perf_counter()
        lgn_path, size = write_lgn_packbits(folder, classes)
        numbers["packbits_write_s"] = time.perf_counter() - t0
        numbers["packbits_mb"] = size / 1e6
        lgn_view = build_lgn_view(lgn_path)
        lgn_req = lgn_request(width, height)
        whole = lgn_view.args[0].args[0]._file_read_plan(lgn_req) is None
        native.reset_counts()
        phases_b, gaussians_b = {}, gaussian_calls()
        with native_spy() as spy:
            host_rate_b, values = check_algebra_path(
                "packbits-landuse", device, lgn_view, lgn_req, "nearest",
                (lgn_req["bbox"][0], lgn_req["bbox"][3]), share=0.0, sampled_tiles=1,
                first_run=(gaussians_b, phases_b), routed=False)
        decodes = dict(native.counts)
        check_native_only("lzw-sheet (b)", spy)
        strips = -(-height // PACKBITS_ROWS)
        check(decodes["tiff_decodes"] == strips if whole else decodes["tiff_decodes"] >= strips,
              "lzw-sheet (b): %d native PackBits decodes of %d strips"
              % (decodes["tiff_decodes"], strips))
        check(values.shape == expected.shape and values.dtype == expected.dtype
              and np.array_equal(values, expected), "lzw-sheet (b): the answer differs from "
              "hfa-roughness'")
        del values, expected
        numbers.update(packbits_phases_s=phases_b, packbits_decodes=decodes["tiff_decodes"],
                       packbits_decode_s=spy.seconds["tiff_decode_native"])
        print("lzw-sheet (b): %d x %d land-use classes as a stripped PackBits GeoTIFF (%d rows a "
              "strip) written in %.2f s, %.1f MB, read %s; every cell equal to "
              "hfa-roughness' answer; %d native PackBits decodes in %.3f s summed, at most %d "
              "at once, no Python decode; first run %s; Gaussian %d launches [%s]" % (
                  width, height, PACKBITS_ROWS, numbers["packbits_write_s"], size / 1e6,
                  "whole" if whole else "by window",
                  decodes["tiff_decodes"], spy.seconds["tiff_decode_native"],
                  spy.most["tiff_decode_native"],
                  ", ".join("%s %.4f s" % kv for kv in phases_b.items()),
                  cuda_stencils.launches - launches_a, card))
        timed.append(plain_gaussian_check("lzw-sheet (b)", gaussians_b,
                                          gaussian_blur_reference))
        del classes

        # (d) the host pool: sampled tiles of (a) in the workers
        t0 = time.perf_counter()
        pool.wait_for_workers(pool_workers, timeout=120)
        numbers["pool_join_s"] = time.perf_counter() - t0
        picks = list(range(0, len(tiles), max(1, len(tiles) // POOL_TILES)))[:POOL_TILES]
        t0 = time.perf_counter()
        for k in picks:
            graph, name = view.get_compute_graph(**tiles[k])
            (pooled,) = pool.scheduler(graph, [name])
            here = compute_host(graph, name)
            check(pooled["values"].dtype == here["values"].dtype
                  and np.array_equal(pooled["values"], here["values"]),
                  "lzw-sheet (d): tile %d from the pool differs from compute_host" % k)
        numbers["pool_s"] = time.perf_counter() - t0
        with urllib.request.urlopen("http://%s/status.json" % pool.dashboard_address,
                                    timeout=30) as response:
            status = json.loads(response.read())
        check(status["n_workers"] == pool_workers and status["completed"] > 0
              and status["failed"] == 0 and len(status["per_worker"]) >= 1,
              "lzw-sheet (d): the pool's status %r" % status)
        numbers["pool_status"] = status
        print("lzw-sheet (d): a HostPool of %d local workers (started with the phase, waited "
              "for %.2f s here) answered %d sampled tiles' graphs equal to compute_host "
              "in %.2f s; /status.json: %d tasks completed, %d failed, %d workers" % (
                  pool_workers, numbers["pool_join_s"], len(picks), numbers["pool_s"],
                  status["completed"], status["failed"], status["n_workers"]))

        # the plain decoder on PYTHON_ROWS rows of the central file tile,
        # one stream, against the native decoder on it and on the tile
        f, _, tags = _open_tiff(path)
        try:
            middle = len(tags[324]) // 2
            f.seek(tags[324][middle])
            chunk = f.read(tags[325][middle])
        finally:
            f.close()
        t0 = time.perf_counter()
        tile = native.tiff_decode_native("lzw", chunk, LZW_TILE * LZW_TILE * 4)
        native_s = time.perf_counter() - t0
        band = lzw_encode(np.frombuffer(tile, np.uint8)[: PYTHON_ROWS * LZW_TILE * 4])
        t0 = time.perf_counter()
        plain = _lzw_decode(band)
        python_s = time.perf_counter() - t0
        check(plain == native.tiff_decode_native("lzw", band, len(plain))
              == tile[: len(plain)] and len(plain) == PYTHON_ROWS * LZW_TILE * 4,
              "lzw-sheet: the Python decode differs from the native one")
        numbers.update(python_band_s=python_s, python_band_bytes=len(plain),
                       native_tile_s=native_s, native_tile_bytes=len(tile))
        print("lzw-sheet: the central file tile (%d bytes of LZW, %d decoded) natively in %.5f s "
              "(%.1f MB/s); its first %d rows as one stream (%d bytes, %d decoded) in Python "
              "%.3f s (%.4f MB/s), the native decode's bytes [%s]" % (
                  len(chunk), len(tile), native_s, len(tile) / 1e6 / native_s, PYTHON_ROWS,
                  len(band), len(plain), python_s, len(plain) / 1e6 / python_s, card))
    finally:
        pool.close()
        stop_processes(procs)
    for name in (path, lgn_path, lgn_path + ".aux.xml"):
        os.remove(name)
    pipeline.clear_read_cache()
    # the path's launches, read before the kernel's timing launches it
    path_launches = {"gaussian_blur": cuda_stencils.launches,
                     "moving_max": cuda_stencils.moving_max_launches}
    kernels = [dict(time_gaussian(planes, sigma), max_abs_err=err, path=label)
               for label, planes, sigma, err in timed if planes.is_cuda]
    del timed
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("lzw-sheet: Gaussian %d launches on the path; the phase %.2f s [%s]"
          % (path_launches["gaussian_blur"], numbers["phase_s"], card))
    return path_launches, numbers, kernels


# --- ortho-jpeg: JPEG GeoTIFF, JPEG tile pyramids, JPEG GetMaps, small
# JPEG/BMP/GIF/NITF files and the codec's recorded hashes ---

ORTHO_PX = 8192
ORTHO_CELL = 0.25
#: the orthophoto's north-west corner in EPSG:28992, inside the sheet's area
ORTHO_ORIGIN = (SHEET_ORIGIN[0] + 1000.0, SHEET_ORIGIN[1] - 1000.0)
ORTHO_TILE = 512  # the GeoTIFF's tiles
ORTHO_QUALITY = 75  # Pillow's default, the encoder's one quality
ORTHO_TIME = datetime(2024, 4, 12, 11, 0, 0)  # the red band's frame; green and blue follow
ORTHO_BAND_STEP = timedelta(seconds=1)
ORTHO_FIELD_PX = 160  # 40 m fields
ORTHO_SMOOTH_M = 1.0
ORTHO_BINS = [-40.0, -10.0, 0.0, 10.0, 25.0, 50.0]
ORTHO_SAMPLED = 8
ORTHO_SUB_PX = 2048  # the pyramids' sub-area and the whole-read .jpg
ORTHO_PYRAMID_TILE = 256
ORTHO_PYRAMID_ZOOM = 18
ORTHO_WMS_ZOOMS = (17, 18, 19)
ORTHO_WMS_PER_ZOOM = 16
ORTHO_WMS_RANGE = (-40.0, 60.0)  # vmin, vmax of the GetMaps' colour map
#: (a)'s windowed-read limit: the 8192^2 file is 64 Mi px, just not above
#: the default, so it would be read whole; the sub-area files stay whole
ORTHO_WINDOW_LIMIT = 16 * 2**20
ORTHO_NITF_PX = 1024
ORTHO_NITF_BLOCK = 256
ORTHO_GIF_PX = 512
ORTHO_PAM_NODATA = 0
#: the codec's fixtures, written with Pillow (tests/test_torch_jpeg.py)
#: and their hashes: Pillow's decoded arrays and Pillow's encodes of
#: jpeg_fixture_array's arrays
JPEG_FIXTURE_DIR = os.path.join("tests", "data", "torch_jpeg")
JPEG_FIXTURES = {
    # name: (Pillow mode, (height, width), Pillow's save options)
    "progressive.jpg": ("RGB", (61, 47), {"progressive": True, "quality": 80}),
    "restart.jpg": ("RGB", (40, 72), {"restart_marker_blocks": 5}),
    "subsampling-422.jpg": ("RGB", (33, 50), {"subsampling": 1}),
    "gray.jpg": ("L", (45, 39), {"quality": 90}),
    "cmyk-adobe.jpg": ("CMYK", (24, 40), {}),
    "odd-1x17.jpg": ("RGB", (1, 17), {}),
    "odd-37x53.jpg": ("RGB", (37, 53), {"optimize": True, "quality": 95}),
    "adobe-rgb.jpg": ("RGB", (30, 30), {"keep_rgb": True}),
}
JPEG_ENCODES = {"rgb-256x256": ("RGB", (256, 256)), "rgb-53x37": ("RGB", (37, 53)),
                "l-100x75": ("L", (75, 100))}


def jpeg_fixture_array(mode, shape):
    """A deterministic (height, width[, bands]) uint8 array for a fixture:
    smooth gradients and a little integer texture, the same on any
    machine (no random generator)."""
    height, width = shape
    bands = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    y, x = np.mgrid[0:height, 0:width].astype(np.int64)
    layers = [((x * (3 + 2 * b) + y * (5 + b) + (x * y * (b + 1)) % (7 + b) * 9) % 256)
              for b in range(bands)]
    array = np.stack(layers, axis=-1).astype(np.uint8)
    return array[..., 0] if bands == 1 else array


def jpeg_fixture_hashes():
    """The fixture folder's recorded hashes (hashes.json) and its path."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), JPEG_FIXTURE_DIR)
    with open(os.path.join(folder, "hashes.json")) as f:
        return folder, json.load(f)


def array_sha256(array):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def check_jpeg_fixtures(card):
    """The codec against libjpeg-turbo without Pillow: every fixture
    decoded natively to the shape and SHA-256 of Pillow's array, every
    encode of jpeg_fixture_array's arrays to the SHA-256 of Pillow's
    bytes.  Returns the count of hashes held."""
    import hashlib

    from dask_geomodeling_tpu_torch.native import jpeg_decode_native, jpeg_encode_native

    folder, recorded = jpeg_fixture_hashes()
    check(sorted(recorded["decoded"]) == sorted(JPEG_FIXTURES)
          and sorted(recorded["encoded"]) == sorted(JPEG_ENCODES),
          "ortho-jpeg (e): hashes.json names other fixtures than JPEG_FIXTURES")
    for name, want in recorded["decoded"].items():
        with open(os.path.join(folder, name), "rb") as f:
            pixels = jpeg_decode_native(f.read())
        check(list(pixels.shape) == want["shape"] and array_sha256(pixels) == want["sha256"],
              "ortho-jpeg (e): %s decodes otherwise than Pillow" % name)
    for name, want in recorded["encoded"].items():
        blob = jpeg_encode_native(jpeg_fixture_array(*JPEG_ENCODES[name]))
        check(hashlib.sha256(blob).hexdigest() == want["sha256"],
              "ortho-jpeg (e): the encode of %s differs from Pillow's" % name)
    held = len(recorded["decoded"]) + len(recorded["encoded"])
    print("ortho-jpeg (e): %d fixtures decoded and %d arrays encoded natively, every SHA-256 "
          "Pillow's (libjpeg-turbo 3.1.3) [%s]" % (len(recorded["decoded"]),
                                                   len(recorded["encoded"]), card))
    return held


def ortho_pixels(width, height, seed=47, field_px=ORTHO_FIELD_PX):
    """(height, width, 3) uint8 RGB of a synthetic 25 cm orthophoto:
    fields of ``field_px`` pixels (grass, crops, bare soil, roofs, water),
    each with its own colour, gray roads along every fourth field edge,
    and pixel texture (a 1024^2 block of noise, repeated)."""
    rng = np.random.default_rng(seed)
    ny, nx = -(-height // field_px), -(-width // field_px)
    base = np.array([[72, 118, 52], [112, 138, 64], [150, 122, 92], [168, 84, 70],
                     [46, 70, 88]], np.int16)
    kind = rng.choice(len(base), size=(ny, nx), p=[0.35, 0.3, 0.15, 0.15, 0.05])
    colours = np.clip(base[kind] + rng.integers(-18, 19, (ny, nx, 3)), 0, 215).astype(np.uint8)
    pixels = np.ascontiguousarray(
        colours.repeat(field_px, axis=0)[:height].repeat(field_px, axis=1)[:, :width])
    block = 1024
    noise = rng.integers(0, 40, (min(block, height), min(block, width), 3), dtype=np.uint8)
    for row in range(0, height, block):
        for col in range(0, width, block):
            piece = pixels[row : row + block, col : col + block]
            piece += noise[: piece.shape[0], : piece.shape[1]]
    road = 12
    for edge in range(0, height, 4 * field_px):
        pixels[edge : edge + road] = 128
    for edge in range(0, width, 4 * field_px):
        pixels[:, edge : edge + road] = 128
    return pixels


def split_jpeg_tables(stream):
    """(tables, abbreviated) of a JPEG stream, as libtiff stores a JPEG
    tile: SOI, the DQT and DHT segments and EOI (the JPEGTables tag), and
    SOI, the other segments but the JFIF APP0 (libtiff's tiles carry
    none), the scan and EOI (the tile)."""
    tables, rest = [b"\xff\xd8"], [b"\xff\xd8"]
    pos = 2
    while True:
        marker = stream[pos + 1]
        if marker == 0xDA:
            rest.append(stream[pos:])
            break
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        segment = stream[pos : pos + 2 + length]
        if marker != 0xE0:
            (tables if marker in (0xDB, 0xC4) else rest).append(segment)
        pos += 2 + length
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def write_jpeg_geotiff(path, pixels, geo_transform, tile=ORTHO_TILE):
    """The (h, w, 3) RGB ``pixels`` as GDAL writes COMPRESS=JPEG
    PHOTOMETRIC=YCBCR: tile^2 tiles (edge tiles padded by repeating the
    last row and column), Photometric 6, YCbCrSubsampling 2,2, each tile
    an abbreviated YCbCr stream at ORTHO_QUALITY (component ids 1, 2, 3, no
    JFIF marker) from the port's encoder on its codec pool, the shared
    tables in JPEGTables (347).  Returns the chunks' bytes in all."""
    from dask_geomodeling_tpu_torch.io.geotiff import _map_chunks
    from dask_geomodeling_tpu_torch.native import jpeg_encode_native

    height, width = pixels.shape[:2]
    corners = [(row, col) for row in range(0, height, tile) for col in range(0, width, tile)]

    def encode(corner):
        row, col = corner
        piece = pixels[row : row + tile, col : col + tile]
        if piece.shape[:2] != (tile, tile):
            piece = np.pad(piece, ((0, tile - piece.shape[0]), (0, tile - piece.shape[1]), (0, 0)),
                           mode="edge")
        return split_jpeg_tables(jpeg_encode_native(piece))

    encoded = _map_chunks(encode, corners)
    tables = encoded[0][0]
    check(all(t == tables for t, _ in encoded), "write_jpeg_geotiff: the tiles' tables differ")
    chunks = [chunk for _, chunk in encoded]
    tags = [(256, "I", [width]), (257, "I", [height]), (258, "H", [8, 8, 8]), (259, "H", [7]),
            (262, "H", [6]), (277, "H", [3]), (284, "H", [1]), (322, "H", [tile]),
            (323, "H", [tile]), (339, "H", [1, 1, 1]), (347, "B", tables), (530, "H", [2, 2])]
    write_tiff_layout(path, tags, chunks, geo_transform, "EPSG:28992", tiled=True)
    return sum(len(c) for c in chunks)


def ortho_geo_transform(origin=ORTHO_ORIGIN, cell=ORTHO_CELL):
    return (origin[0], cell, 0.0, origin[1], 0.0, -cell)


def ortho_request(px, origin=ORTHO_ORIGIN, cell=ORTHO_CELL, projection="EPSG:28992"):
    """A ``px``^2 request of ``cell`` m from ``origin`` (north-west) at the
    green band's time."""
    green = ORTHO_TIME + ORTHO_BAND_STEP
    x0, y0 = origin
    return dict(mode="vals", projection=projection, width=px, height=px,
                bbox=(x0, y0 - px * cell, x0 + px * cell, y0), start=green, stop=green)


def build_ortho_view(path):
    """(Classify(smooth, ORTHO_BINS), smooth) over the image at ``path``,
    its bands frames of one RasterFileSource (red, green, blue a second
    apart): smooth the excess-green index 2G - R - B (red and blue brought
    to the green band's time by Shift; 2.0 promotes the uint8 bands to
    float64) smoothed over ORTHO_SMOOTH_M."""
    from dask_geomodeling_tpu_torch import raster as port

    source = port.RasterFileSource(path, time_first=ORTHO_TIME, time_delta=ORTHO_BAND_STEP)
    red = port.Shift(source, ORTHO_BAND_STEP)
    blue = port.Shift(source, -ORTHO_BAND_STEP)
    excess_green = port.Subtract(port.Subtract(port.Multiply(source, 2.0), red), blue)
    smooth = port.Smooth(excess_green, ORTHO_SMOOTH_M)
    return port.Classify(smooth, ORTHO_BINS), smooth


def jpeg_spy():
    """A call_spy over the native JPEG codec and the port's Python BMP and
    GIF decoders."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.io import jpeg

    return call_spy([(native, "jpeg_decode_native"), (native, "jpeg_encode_native"),
                     (jpeg, "_decode_bmp"), (jpeg, "_decode_gif")])


def rewrite_tiles_as_jpeg(path):
    """Every PNG tile of the GeoPackage or MBTiles file at ``path``
    re-encoded as a JPEG at the defaults (the port's encoder); returns the
    tiles rewritten."""
    import sqlite3

    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.native import jpeg_encode_native

    con = sqlite3.connect(path)
    try:
        tables = [row[0] for row in con.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'")]
        table = "tiles" if "tiles" in tables else con.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type = 'tiles'").fetchone()[0]
        rows = con.execute("SELECT rowid, tile_data FROM %s" % table).fetchall()
        for rowid, blob in rows:
            array, _ = decode_png_bytes(blob)
            pixels = array[0] if array.shape[0] == 1 else np.ascontiguousarray(
                array[:3].transpose(1, 2, 0))
            con.execute("UPDATE %s SET tile_data = ? WHERE rowid = ?" % table,
                        (jpeg_encode_native(pixels), rowid))
        if "metadata" in tables:
            con.execute("UPDATE metadata SET value = 'jpg' WHERE name = 'format'")
        con.commit()
    finally:
        con.close()
    return len(rows)


def bmp_bytes(pixels, palette=None):
    """A Windows bitmap (BITMAPINFOHEADER, bottom-up rows): 24-bit BGR of
    (h, w, 3) ``pixels``, or 8-bit indices (h, w) over ``palette``
    ((n, 3) RGB)."""
    height, width = pixels.shape[:2]
    if palette is None:
        rows = pixels[::-1, :, ::-1].reshape(height, width * 3)
        bits, table = 24, b""
    else:
        rows = pixels[::-1]
        bits = 8
        table = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                                np.zeros((len(palette), 1), np.uint8)], axis=1).tobytes()
    stride = -(-rows.shape[1] // 4) * 4
    body = np.zeros((height, stride), np.uint8)
    body[:, : rows.shape[1]] = rows
    offset = 14 + 40 + len(table)
    header = struct.pack("<IiiHHIIiiII", 40, width, height, 1, bits, 0, body.size, 3937, 3937,
                         0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset) + header + table
            + body.tobytes())


def gif_bytes(indices, palette):
    """A GIF89a of the (h, w) uint8 ``indices`` over a 256-colour
    ``palette``: one frame, LZW of 9-bit literal codes, a clear code
    before every 250 of them (so the code width never grows)."""
    height, width = indices.shape
    flat = indices.reshape(-1).astype(np.uint16)
    run = 250
    n_runs = -(-flat.size // run)
    codes = np.full(flat.size + n_runs + 1, 256, np.uint16)
    at = np.arange(flat.size)
    codes[at + at // run + 1] = flat
    codes[-1] = 257
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[k : k + 255])]) + data[k : k + 255]
                      for k in range(0, len(data), 255))
    table = np.zeros((256, 3), np.uint8)
    table[: len(palette)] = palette
    return (b"GIF89a" + struct.pack("<HHBBB", width, height, 0xF7, 0, 0) + table.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, width, height, 0) + b"\x08" + blocks
            + b"\x00;")


def cube_palette(pixels):
    """(indices, palette): ``pixels`` (h, w, 3) on the 6 x 6 x 6 colour
    cube."""
    levels = np.arange(6, dtype=np.uint8) * 51
    palette = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    q = (pixels.astype(np.uint16) + 25) // 51
    return (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8), palette


def write_world_file(path, geo_transform):
    """An ESRI world file (the upper-left pixel's centre)."""
    x0, a, _, y0, _, d = geo_transform
    with open(path, "w") as f:
        f.write("\n".join("%.10f" % v for v in (a, 0.0, 0.0, d, x0 + a / 2, y0 + d / 2)) + "\n")


def write_ortho_nitf(folder, pixels, block=ORTHO_NITF_BLOCK, absent=((0, 3), (3, 0)),
                     name="ortho.ntf"):
    """A NITF 2.1 file of two RGB segments over scene_igeolo's corners:
    C3, the (n, n, 3) ``pixels`` as one JPEG, and M3, the same pixels
    mirrored in ``block``^2 JPEG blocks with the blocks ``absent`` left out
    (pad code 0).  Returns (path, the (6, n, n) values a reader gives)."""
    from dask_geomodeling_tpu_torch.native import jpeg_decode_native, jpeg_encode_native

    n = pixels.shape[0]
    whole = jpeg_encode_native(pixels)
    mirrored = np.ascontiguousarray(pixels[:, ::-1])
    per_row = n // block
    streams, offsets, at = [], [], 0
    expected = np.zeros((3, n, n), np.uint8)
    for k in range(per_row * per_row):
        r, c = divmod(k, per_row)
        if (r, c) in absent:
            offsets.append(0xFFFFFFFF)
            continue
        piece = mirrored[r * block : (r + 1) * block, c * block : (c + 1) * block]
        stream = jpeg_encode_native(piece)
        expected[:, r * block : (r + 1) * block, c * block : (c + 1) * block] = \
            jpeg_decode_native(stream).transpose(2, 0, 1)
        offsets.append(at)
        streams.append(stream)
        at += len(stream)
    pad = b"\x00"
    mask = (struct.pack(">IHHH", 10 + len(pad) + 4 * len(offsets), 4, 0, 8 * len(pad)) + pad
            + struct.pack(">%dI" % len(offsets), *offsets))
    masked = mask + b"".join(streams)
    common = dict(nbpp=8, abpp=8, irep="MULTI", igeolo=scene_igeolo())
    c3 = nitf_image_subheader(3, n, n, ic="C3", **common)
    m3 = nitf_image_subheader(3, n, n, ic="M3", nbpr=per_row, nbpc=per_row, nppbh=block,
                              nppbv=block, **common)
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        f.write(nitf_file_header([(len(c3), len(whole)), (len(m3), len(masked))]))
        f.write(c3 + whole + m3 + masked)
    values = np.concatenate([jpeg_decode_native(whole).transpose(2, 0, 1), expected])
    return path, values


def ortho_small_files(folder, pixels, gif_px=ORTHO_GIF_PX, nitf_px=ORTHO_NITF_PX):
    """(d)'s files from the (n, n, 3) ``pixels`` (RD New, ORTHO_ORIGIN):
    a JPEG with .jgw, .prj and a PAM nodata, an 8-bit palette BMP and a
    24-bit BMP (.bpw), a GIF (.gfw) of the first ``gif_px``^2 and
    write_ortho_nitf of the first ``nitf_px``^2.  Returns {label: (path,
    request)}: the file's grid (the NITF's quadrants, and its whole at
    half resolution)."""
    from dask_geomodeling_tpu_torch.native import jpeg_encode_native

    n = pixels.shape[0]
    geo_transform = ortho_geo_transform()
    files = {}
    jpg = os.path.join(folder, "ortho.jpg")
    with open(jpg, "wb") as f:
        f.write(jpeg_encode_native(pixels))
    write_world_file(jpg[:-4] + ".jgw", geo_transform)
    with open(jpg[:-4] + ".prj", "w") as f:
        f.write("EPSG:28992")
    with open(jpg + ".aux.xml", "w") as f:
        f.write('<PAMDataset><PAMRasterBand band="1"><NoDataValue>%d</NoDataValue>'
                "</PAMRasterBand></PAMDataset>" % ORTHO_PAM_NODATA)
    files["jpg"] = (jpg, ortho_request(n))
    indices, palette = cube_palette(pixels)
    for label, blob in (("bmp-8bit", bmp_bytes(indices, palette)), ("bmp-24bit", bmp_bytes(pixels))):
        path = os.path.join(folder, label + ".bmp")
        with open(path, "wb") as f:
            f.write(blob)
        write_world_file(path[:-4] + ".bpw", geo_transform)
        files[label] = (path, ortho_request(n))
    gif = os.path.join(folder, "ortho.gif")
    with open(gif, "wb") as f:
        f.write(gif_bytes(indices[:gif_px, :gif_px], palette))
    write_world_file(gif[:-4] + ".gfw", geo_transform)
    files["gif"] = (gif, ortho_request(gif_px))
    nitf_path, _ = write_ortho_nitf(folder, pixels[:nitf_px, :nitf_px])
    # at its own grid, a quadrant a request (one tile: a geographic
    # Smooth's sigma differs between tile rows): the C3 segment's green
    # frame (1) in the north-west, the M3 segment's (4) in the north-east,
    # over an absent block; and the C3 segment's whole at half its
    # resolution, where each cell's centre falls on a corner of four
    # pixels (nearest-sampling ties)
    x0, dx, _, y0, _, dy = scene_geo_transform(nitf_px)
    half = nitf_px // 2
    for label, frame, col, span in (("nitf", 1, 0, half), ("nitf-m3", 4, half, half),
                                    ("nitf-half", 1, 0, nitf_px)):
        when = ORTHO_TIME + frame * ORTHO_BAND_STEP
        files[label] = (nitf_path, dict(
            mode="vals", projection="EPSG:4326", width=half, height=half,
            bbox=(x0 + col * dx, y0 + span * dy, x0 + (col + span) * dx, y0), start=when,
            stop=when))
    return files


def tie_report(device, view, smooth, request, card):
    """Where the card's classes of ``view`` part from compute_host's, which
    stage parts: the cells whose excess-green index (the nearest-sampled
    bands, before Smooth) differs, and the largest difference of the
    smoothed index over the cells whose class differs.  Prints and
    returns them."""
    from dask_geomodeling_tpu_torch import compute_host, get_data

    def both(block):
        return (get_data(block, device=device, **request)["values"],
                compute_host(*block.get_compute_graph(**request))["values"])

    card_classes, host_classes = both(view)
    card_index, host_index = both(smooth.args[0])
    card_smooth, host_smooth = both(smooth)
    parted = card_classes != host_classes
    report = dict(classes=int(parted.sum()), index_cells=int((card_index != host_index).sum()),
                  smooth_max_abs=float(np.abs(card_smooth - host_smooth)[parted].max())
                  if parted.any() else 0.0,
                  smooth_cells=int((card_smooth != host_smooth).sum()))
    print("ortho-jpeg (d) nitf-half: %(classes)d cells of another class than compute_host's; "
          "the excess-green index differs in %(index_cells)d cells, the smoothed index in "
          "%(smooth_cells)d (by at most %(smooth_max_abs).3g where the class differs)" % report
          + " [%s]" % card)
    return report


def ortho_wms_tiles(bbox, zooms=ORTHO_WMS_ZOOMS, per_zoom=ORTHO_WMS_PER_ZOOM):
    """``per_zoom`` XYZ tiles of each zoom inside the EPSG:3857 ``bbox``,
    spread over it."""
    picked = []
    for z in zooms:
        inside = [t for t in xyz_tiles(bbox, (z,))
                  if xyz_bbox(*t)[0] >= bbox[0] and xyz_bbox(*t)[2] <= bbox[2]
                  and xyz_bbox(*t)[1] >= bbox[1] and xyz_bbox(*t)[3] <= bbox[3]]
        picks = np.linspace(0, len(inside) - 1, min(per_zoom, len(inside))).round().astype(int)
        picked += [inside[k] for k in picks]
    return picked


def check_ortho_jpeg(card, device, folder, px=ORTHO_PX, sub_px=ORTHO_SUB_PX,
                     sampled_tiles=ORTHO_SAMPLED, wms_per_zoom=ORTHO_WMS_PER_ZOOM,
                     gif_px=ORTHO_GIF_PX, nitf_px=ORTHO_NITF_PX, pixels=None):
    """The ortho-jpeg phase.  (e) check_jpeg_fixtures first.  (a) ortho_pixels
    as a JPEG GeoTIFF (write_jpeg_geotiff), build_ortho_view at its grid
    through check_algebra_path (every sampled tile bitwise to
    compute_host), every chunk decoded natively (no Python decoder), the
    Gaussian's first frames torch.equal to its plain version.  (b) the
    first ``sub_px``^2 as a GeoPackage of 256^2 JPEG tiles in RD New and as
    zoom-18 MBTiles in EPSG:3857 asked in RD New, each bitwise to
    compute_host.  (c) image/jpeg GetMaps of the smoothed layer from the
    WSGI server, ``wms_per_zoom`` tiles of each of zooms 17-19, cold then
    warm: the warm bodies the cold ones, each body the encoder's bytes of
    compute_host's composited pixels (or, where the card's values part
    from the host's in a cross-CRS nearest warp, within HEADLINE_SHARE,
    the encoder's bytes of the card's); p50, p99 and the encode's share.  (d) ortho_small_files, each read whole
    through RasterFileSource and the card route against compute_host
    (bitwise; the NITF at half resolution within HEADLINE_SHARE, with
    tie_report).  ``pixels``, ortho_pixels(px, px) when given (drawn once
    for this phase and ortho-webp), else drawn here.  Returns (launches,
    numbers, the Gaussian's kernel records on the card); removes its
    files."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host, get_data, native
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.io.gpkg_raster import write_gpkg_raster
    from dask_geomodeling_tpu_torch.io.mbtiles import write_mbtiles
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import (
        encode_tile, register_layer, tile_values, unregister_layers,
    )
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime import pipeline

    phase_t0 = time.perf_counter()
    numbers = {}
    cuda_stencils.reset_launches()
    numbers["fixture_hashes"] = check_jpeg_fixtures(card)

    # (a) the orthophoto as a JPEG GeoTIFF, by window
    t0 = time.perf_counter()
    if pixels is None:
        pixels = ortho_pixels(px, px)
    numbers["draw_s"] = time.perf_counter() - t0
    path = os.path.join(folder, "ortho.tif")
    native.reset_counts()
    t0 = time.perf_counter()
    size = write_jpeg_geotiff(path, pixels, ortho_geo_transform())
    numbers["write_s"] = time.perf_counter() - t0
    encodes = native.counts["jpeg_encodes"]
    numbers.update(jpeg_mb=size / 1e6, tiles_encoded=encodes)
    print("ortho-jpeg (a): a %d^2 RGB orthophoto of %.2f m drawn in %.2f s, written as a JPEG "
          "GeoTIFF (%d^2 YCbCr 4:2:0 tiles, quality %d, JPEGTables) by %d native encodes in "
          "%.2f s: %.1f MB (%.4f of the raw bytes) [%s]" % (
              px, ORTHO_CELL, numbers["draw_s"], ORTHO_TILE, ORTHO_QUALITY, encodes,
              numbers["write_s"], size / 1e6, size / pixels.size, card))
    pipeline.clear_read_cache()
    view, smooth = build_ortho_view(path)
    source = smooth.args[0].args[1].args[0]
    request = ortho_request(px)
    limit = {"geomodeling.windowed-read-limit": min(
        ORTHO_WINDOW_LIMIT, config.get("geomodeling.windowed-read-limit"))}
    native.reset_counts()
    phases, gaussians = {}, gaussian_calls()
    with config.set(limit), jpeg_spy() as spy, native_spy() as plain:
        check(np.dtype(source.info.dtype) == np.uint8 and source.info.bands == 3
              and (source.info.width, source.info.height) == (px, px)
              and source._file_read_plan(request) is not None,
              "ortho-jpeg (a): info %r, or the read is not windowed" % (source.info,))
        host_rate, values = check_algebra_path(
            "ortho-jpeg", device, view, request, "nearest", (request["bbox"][0],
                                                            request["bbox"][3]),
            share=0.0, sampled_tiles=sampled_tiles, first_run=(gaussians, phases), routed=False)
    decodes = dict(native.counts)
    check_native_only("ortho-jpeg (a)", plain)
    check(decodes["jpeg_decodes"] > 0 and spy.calls["jpeg_decode_native"]
          == decodes["jpeg_decodes"] and not spy.calls["_decode_bmp"]
          and not spy.calls["_decode_gif"], "ortho-jpeg (a): %r native decodes" % decodes)
    launches_a = cuda_stencils.launches
    check(launches_a > 0, "ortho-jpeg (a): the Gaussian did not launch")
    planes = gaussians.first[0]
    seconds = spy.seconds["jpeg_decode_native"]
    numbers.update(first_phases_s=phases, host_mpx_per_s=host_rate,
                   native_decodes=decodes["jpeg_decodes"], decoded_mb=decodes["jpeg_bytes"] / 1e6,
                   decode_s=seconds, decode_mb_per_s=decodes["jpeg_bytes"] / 1e6 / seconds,
                   most_decodes_at_once=spy.most["jpeg_decode_native"],
                   gaussian_dtype=str(planes.dtype).replace("torch.", ""),
                   gaussian_launches_a=launches_a,
                   classes_share={str(int(k)): float(v) for k, v in zip(
                       *np.unique(values, return_counts=True))})
    numbers["classes_share"] = {k: v / values.size for k, v in numbers["classes_share"].items()}
    del values
    print("ortho-jpeg (a): %d native JPEG decodes, %.1f MB in %.3f s summed over threads (%.1f "
          "MB/s a thread), at most %d at once; no Python decode; first run %s; Gaussian %d "
          "launches on %s frames [%s]" % (
              decodes["jpeg_decodes"], numbers["decoded_mb"], seconds,
              numbers["decode_mb_per_s"], numbers["most_decodes_at_once"],
              ", ".join("%s %.4f s" % kv for kv in phases.items()), launches_a,
              numbers["gaussian_dtype"], card))
    timed = [plain_gaussian_check("ortho-jpeg (a)", gaussians, gaussian_blur_reference)]

    # (b) the pyramids over the first sub_px^2
    sub = np.ascontiguousarray(pixels[:sub_px, :sub_px])
    del pixels
    sub_request = ortho_request(sub_px)
    gpkg = os.path.join(folder, "ortho.gpkg")
    write_gpkg_raster(gpkg, sub.transpose(2, 0, 1), ortho_geo_transform(),
                      projection="EPSG:28992", tile_size=ORTHO_PYRAMID_TILE)
    rewritten = {"gpkg": rewrite_tiles_as_jpeg(gpkg)}
    merc_gt, merc_w, merc_h = mercator_box(sub_request, ORTHO_PYRAMID_ZOOM, ORTHO_PYRAMID_TILE)
    mbt = os.path.join(folder, "ortho.mbtiles")
    write_mbtiles(mbt, ortho_pixels(merc_w, merc_h, seed=48).transpose(2, 0, 1), merc_gt,
                  projection="EPSG:3857", name="ortho", tile_size=ORTHO_PYRAMID_TILE)
    rewritten["mbtiles"] = rewrite_tiles_as_jpeg(mbt)
    pyramids = {}
    for label, pyramid in (("gpkg", gpkg), ("mbtiles", mbt)):
        pipeline.clear_read_cache()
        native.reset_counts()
        t0 = time.perf_counter()
        with jpeg_spy() as spy:
            pyramid_view, _ = build_ortho_view(pyramid)
            check_algebra_path("ortho-jpeg (b) " + label, device, pyramid_view, sub_request,
                               "nearest", (sub_request["bbox"][0], sub_request["bbox"][3]),
                               share=0.0, sampled_tiles=2, routed=False)
        check(native.counts["jpeg_decodes"] >= rewritten[label],
              "ortho-jpeg (b) %s: %d native decodes of %d tiles"
              % (label, native.counts["jpeg_decodes"], rewritten[label]))
        pyramids[label] = dict(tiles=rewritten[label], decodes=native.counts["jpeg_decodes"],
                               decode_s=spy.seconds["jpeg_decode_native"],
                               seconds=time.perf_counter() - t0)
    numbers["pyramids"] = pyramids
    print("ortho-jpeg (b): a GeoPackage of %d and a zoom-%d MBTiles of %d 256^2 JPEG tiles, "
          "each read whole (%s) and asked in RD New at %d^2: every sampled tile bitwise to "
          "compute_host [%s]" % (rewritten["gpkg"], ORTHO_PYRAMID_ZOOM, rewritten["mbtiles"],
                                 ", ".join("%s %d decodes in %.3f s" % (k, v["decodes"],
                                                                       v["decode_s"])
                                           for k, v in pyramids.items()), sub_px, card))
    for name in (gpkg, mbt):
        os.remove(name)

    # (c) image/jpeg GetMaps of the smoothed layer
    bbox = Extent(request["bbox"], "EPSG:28992").transformed("EPSG:3857").bbox
    tiles = ortho_wms_tiles(bbox, per_zoom=wms_per_zoom)
    style, (vmin, vmax) = "viridis", ORTHO_WMS_RANGE
    when = (ORTHO_TIME + ORTHO_BAND_STEP).strftime("%Y-%m-%dT%H:%M:%S.%fZ")

    def params(tile):
        query = getmap_params("ortho-exg", style, vmin, vmax, tile)
        query.update(FORMAT="image/jpeg", TIME=when)
        return query

    register_layer("ortho-exg", smooth)
    client = WMSClient()
    passes = {}
    launches_before = cuda_stencils.launches
    try:
        with config.set({"geomodeling.result-cache-size": 0}):
            pipeline.clear_read_cache()
            for label in ("cold", "warm"):
                bodies, seconds = [], []
                with jpeg_spy() as spy:
                    for tile in tiles:
                        status, content_type, body, took = client.get(params(tile))
                        check(status == 200 and content_type == "image/jpeg"
                              and body[:3] == b"\xff\xd8\xff",
                              "ortho-jpeg (c): GetMap %r answered %s %s %r"
                              % (tile, status, content_type, body[:80]))
                        bodies.append(body)
                        seconds.append(took)
                passes[label] = dict(latency_numbers(seconds), bodies=bodies,
                                     encode_s=spy.seconds["jpeg_encode_native"],
                                     encodes=spy.calls["jpeg_encode_native"],
                                     total_s=float(sum(seconds)))
        check(passes["warm"]["bodies"] == passes["cold"]["bodies"],
              "ortho-jpeg (c): the warm bodies differ from the cold ones")
        launches_c = cuda_stencils.launches - launches_before
        # each body against the encoder's bytes of the host route's pixels
        # (compute_host, coloured and composited in process); a tile whose
        # host and card values part (a cross-CRS nearest tie) is held
        # within HEADLINE_SHARE and to the encoder's bytes of the card's
        equal, worst = 0, 0.0
        for k, tile in enumerate(tiles):
            tile_req = dict(tile_request(tile), start=request["start"])
            body = passes["cold"]["bodies"][k]
            host = compute_host(*smooth.get_compute_graph(**tile_req))
            if body == encode_tile(tile_values(host, WMS_TILE, WMS_TILE), style, vmin, vmax,
                                   True, 0xFFFFFF, "image/jpeg"):
                equal += 1
                continue
            data = get_data(smooth, device=device, **tile_req)
            differ = float(np.mean(host["values"] != data["values"]))
            worst = max(worst, differ)
            check(0.0 < differ <= HEADLINE_SHARE and body == encode_tile(
                tile_values(data, WMS_TILE, WMS_TILE), style, vmin, vmax, True, 0xFFFFFF,
                "image/jpeg"), "ortho-jpeg (c): GetMap %r is not the encoder's bytes of the "
                  "host's pixels, and its values part from compute_host in %.5f of its cells"
                  % (tile, differ))
    finally:
        client.close()
        unregister_layers()
    for label in passes:
        del passes[label]["bodies"]
        passes[label]["encode_share"] = passes[label]["encode_s"] / passes[label]["total_s"]
    numbers["wms"] = dict(passes, tiles=len(tiles), gaussian_launches=launches_c,
                          host_equal=equal, worst_host_share=worst)
    print("ortho-jpeg (c): %d image/jpeg GetMaps (zooms %s), cold p50 %.2f ms p99 %.2f ms "
          "(encode %.4f of it), warm p50 %.2f ms p99 %.2f ms (encode %.4f); warm bodies equal "
          "to cold; %d of %d bodies the encoder's bytes of compute_host's pixels, the others "
          "within %.5f of compute_host (at most %.5f); Gaussian %d launches [%s]" % (
              len(tiles), "/".join(str(z) for z in ORTHO_WMS_ZOOMS), passes["cold"]["p50_ms"],
              passes["cold"]["p99_ms"], passes["cold"]["encode_share"], passes["warm"]["p50_ms"],
              passes["warm"]["p99_ms"], passes["warm"]["encode_share"], equal, len(tiles),
              HEADLINE_SHARE, worst, launches_c, card))

    # (d) small files, read whole
    small = ortho_small_files(folder, sub, gif_px=gif_px, nitf_px=nitf_px)
    del sub
    numbers["small_files"] = {}
    for label, (small_path, small_request) in small.items():
        pipeline.clear_read_cache()
        native.reset_counts()
        t0 = time.perf_counter()
        with jpeg_spy() as spy:
            # building the view reads the file whole (Shift asks its frames)
            small_view, small_smooth = build_ortho_view(small_path)
            small_source = small_smooth.args[0].args[1].args[0]
            check(small_source._file_read_plan(small_request) is None,
                  "ortho-jpeg (d) %s: the read is windowed" % label)
            # the half-resolution read puts every cell centre on a corner
            # of four pixels: bitwise since the card's index arithmetic
            # divides truly (device.divide), and tie_report says where a
            # stage would part
            check_algebra_path("ortho-jpeg (d) " + label, device, small_view, small_request,
                               "nearest", (small_request["bbox"][0], small_request["bbox"][3]),
                               share=0.0, sampled_tiles=1, routed=False)
            if label == "nitf-half":
                ties = numbers["nitf_half_ties"] = tie_report(device, small_view, small_smooth,
                                                              small_request, card)
                check(ties["classes"] == 0 and ties["index_cells"] == 0,
                      "ortho-jpeg (d) nitf-half: the card's nearest sampling parts from the "
                      "host's: %r" % ties)
        kind = {"gif": "_decode_gif", "bmp-8bit": "_decode_bmp",
                "bmp-24bit": "_decode_bmp"}.get(label, "jpeg_decode_native")
        check(spy.calls[kind] > 0, "ortho-jpeg (d) %s: %s did not run" % (label, kind))
        numbers["small_files"][label] = dict(
            bands=small_source.info.bands, size=(small_source.info.width,
                                                 small_source.info.height),
            no_data_value=small_source.info.no_data_value, decoder=kind,
            decode_s=spy.seconds[kind], seconds=time.perf_counter() - t0)
    check(numbers["small_files"]["jpg"]["no_data_value"] == ORTHO_PAM_NODATA
          and numbers["small_files"]["nitf"]["bands"] == 6
          and numbers["small_files"]["bmp-8bit"]["bands"] == 3,
          "ortho-jpeg (d): %r" % numbers["small_files"])
    print("ortho-jpeg (d): %s, each read whole through RasterFileSource, every sampled tile "
          "bitwise to compute_host [%s]" % ("; ".join(
              "%s %dx%d x %d bands (%s %.3f s)" % (label, *v["size"], v["bands"], v["decoder"],
                                                  v["decode_s"])
              for label, v in numbers["small_files"].items()), card))
    for name in os.listdir(folder):
        if name.startswith(("ortho", "bmp-")):
            os.remove(os.path.join(folder, name))
    pipeline.clear_read_cache()
    path_launches = {"gaussian_blur": cuda_stencils.launches,
                     "moving_max": cuda_stencils.moving_max_launches}
    kernels = [dict(time_gaussian(planes, sigma), max_abs_err=err, path=label)
               for label, planes, sigma, err in timed if planes.is_cuda]
    del timed
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("ortho-jpeg: Gaussian %d launches on the path; the phase %.2f s [%s]"
          % (path_launches["gaussian_blur"], numbers["phase_s"], card))
    return path_launches, numbers, kernels


#: the WebP codec's fixtures, written with Pillow (tests/test_torch_webp.py):
#: lossless files whose decoded arrays' hashes hashes.json records
WEBP_FIXTURE_DIR = os.path.join("tests", "data", "torch_webp")
WEBP_EXIF = b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x00\x00\x00\x00"  # an empty IFD
WEBP_ICC = bytes(range(96))
WEBP_FIXTURES = {
    # name: (Pillow mode, (height, width), palette colours or None, Pillow's save
    # options beside lossless=True)
    "gray-m0-9x1.webp": ("L", (9, 1), None, {"method": 0}),
    "gray-m6-12x257.webp": ("L", (12, 257), None, {"method": 6}),
    "rgb-m6-37x7.webp": ("RGB", (37, 7), None, {"method": 6}),
    "rgb-m0-q0-33x50.webp": ("RGB", (33, 50), None, {"method": 0, "quality": 0}),
    "rgba-exact-24x40.webp": ("RGBA", (24, 40), None, {"exact": True}),
    "palette2-m6-19x257.webp": ("RGB", (19, 257), 2, {"method": 6}),
    "palette4-23x45.webp": ("RGB", (23, 45), 4, {}),
    "palette16-m0-31x29.webp": ("RGBA", (31, 29), 16, {"method": 0}),
    "palette200-40x40.webp": ("RGB", (40, 40), 200, {}),
    "vp8x-exif-icc-16x24.webp": ("RGB", (16, 24), None, {"exif": WEBP_EXIF,
                                                         "icc_profile": WEBP_ICC}),
}
#: the files the codec refuses, written with Pillow too: what each holds
WEBP_REFUSED = {
    "animated-2x16x16.webp": "ANIM",
}
#: lossy files written with Pillow (quality 60), decoded natively to the
#: arrays hashes.json records under "lossy": what each holds
WEBP_LOSSY_FIXTURES = {
    "lossy-32x48.webp": "VP8",
    "lossy-alpha-32x48.webp": "ALPH",
}
ORTHO_WEBP_LAYOUT_TILE = 512  # the contiguous RGB file's tiles (d) and (g)
ORTHO_WEBP_SAMPLED_CHUNKS = 16  # chunks held against deflate
#: (g)'s chunks, in ORTHO_LOSSY_DIR of the fixtures: the four 512^2
#: quadrants (row, column) of ortho_pixels(1024, 1024), and the first again
#: with a nodata mask as its alpha, each Pillow's lossy WebP at GDAL's
#: COMPRESS=WEBP defaults (quality 75, method 4)
ORTHO_LOSSY_DIR = "ortho-lossy"
ORTHO_LOSSY_QUALITY = 75
ORTHO_LOSSY_CHUNKS = {"ortho-0-0.webp": (0, 0), "ortho-0-1.webp": (0, 1),
                      "ortho-1-0.webp": (1, 0), "ortho-1-1.webp": (1, 1),
                      "ortho-alpha.webp": (0, 0)}
ORTHO_LOSSY_ALPHA = "ortho-alpha.webp"
ORTHO_LOSSY_SEED = 71


def webp_fixture_array(mode, shape, colours=None):
    """A deterministic (height, width[, bands]) uint8 array for a WebP
    fixture: smooth gradients and integer texture, or, with ``colours``,
    a pattern of that many palette entries; the same on any machine."""
    height, width = shape
    bands = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    y, x = np.mgrid[0:height, 0:width].astype(np.int64)
    if colours is None:
        layers = [((x * (3 + 2 * b) + y * (5 + b) + (x * y * (b + 1)) % (7 + b) * 9) % 256)
                  for b in range(bands)]
        array = np.stack(layers, axis=-1).astype(np.uint8)
    else:
        k = np.arange(colours, dtype=np.int64)[:, None]
        palette = ((k * 53 + np.arange(bands) * 91 + (k * k) % 17 * 7) % 256).astype(np.uint8)
        if bands == 4:
            palette[:, 3] = np.where(k[:, 0] % 3 == 0, 255, palette[:, 3])
        array = palette[(x * 7 + y * 13 + (x * y) % 5) % colours]
    return array[..., 0] if bands == 1 else array


@functools.lru_cache(maxsize=1)
def _ortho_lossy_block():
    return ortho_pixels(2 * ORTHO_WEBP_LAYOUT_TILE, 2 * ORTHO_WEBP_LAYOUT_TILE)


def ortho_lossy_pixels(name):
    """The pixels of the ORTHO_LOSSY_CHUNKS chunk ``name``: (512, 512, 3),
    or (512, 512, 4) for ORTHO_LOSSY_ALPHA, its alpha 0 inside 12 discs
    drawn from ORTHO_LOSSY_SEED and 255 elsewhere."""
    tile = ORTHO_WEBP_LAYOUT_TILE
    row, col = ORTHO_LOSSY_CHUNKS[name]
    rgb = _ortho_lossy_block()[row * tile : (row + 1) * tile, col * tile : (col + 1) * tile]
    if name != ORTHO_LOSSY_ALPHA:
        return np.ascontiguousarray(rgb)
    rng = np.random.default_rng(ORTHO_LOSSY_SEED)
    y, x = np.mgrid[0:tile, 0:tile]
    alpha = np.full((tile, tile), 255, np.uint8)
    for cy, cx, r in zip(rng.integers(0, tile, 12), rng.integers(0, tile, 12),
                         rng.integers(16, 64, 12)):
        alpha[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = 0
    return np.ascontiguousarray(np.dstack([rgb, alpha]))


def webp_lossy_fixture_names():
    """The lossy fixtures' paths in the fixture folder, as hashes.json
    names them."""
    return list(WEBP_LOSSY_FIXTURES) + [ORTHO_LOSSY_DIR + "/" + name for name in ORTHO_LOSSY_CHUNKS]


def webp_fixture_hashes():
    """The WebP fixture folder's recorded hashes (hashes.json) and its path."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), WEBP_FIXTURE_DIR)
    with open(os.path.join(folder, "hashes.json")) as f:
        return folder, json.load(f)


def check_webp_fixtures(card):
    """(e) and (f): the codec against libwebp without Pillow.  Every
    lossless and lossy fixture (ortho-lossy's chunks among them) decoded
    natively to the shape and SHA-256 of Pillow's array; the animated
    fixture raising NotImplementedError naming the JAX modules that read
    it, and a lossless and a lossy file cut short raising OSError,
    Pillow's class.  Returns (hashes held, the refusals' messages, the
    ortho-lossy chunks' (bytes, checked array) by name)."""
    from dask_geomodeling_tpu_torch.native import webp_decode_native

    folder, recorded = webp_fixture_hashes()
    check(sorted(recorded["decoded"]) == sorted(WEBP_FIXTURES)
          and sorted(recorded["lossy"]) == sorted(webp_lossy_fixture_names()),
          "ortho-webp (e): hashes.json names other fixtures than WEBP_FIXTURES and the lossy ones")
    chunks = {}
    for name, want in list(recorded["decoded"].items()) + list(recorded["lossy"].items()):
        with open(os.path.join(folder, name), "rb") as f:
            blob = f.read()
        pixels = webp_decode_native(blob)
        check(list(pixels.shape) == want["shape"] and array_sha256(pixels) == want["sha256"],
              "ortho-webp (e): %s decodes otherwise than Pillow" % name)
        if name.startswith(ORTHO_LOSSY_DIR + "/"):
            chunks[os.path.basename(name)] = (blob, pixels)
    print("ortho-webp (e): %d lossless and %d lossy fixtures (%d of them ortho-lossy's 512^2 "
          "chunks, quality %d) decoded natively, every SHA-256 Pillow's (libwebp 1.6.0) [%s]"
          % (len(recorded["decoded"]), len(recorded["lossy"]), len(chunks), ORTHO_LOSSY_QUALITY,
             card))
    refusals = {}
    for name, holds in WEBP_REFUSED.items():
        with open(os.path.join(folder, name), "rb") as f:
            blob = f.read()
        try:
            webp_decode_native(blob)
            raised = None
        except NotImplementedError as e:
            raised = str(e)
        check(raised is not None and "dask_geomodeling_tpu/io/" in raised,
              "ortho-webp (f): %s (%s) was not refused naming the JAX module: %r"
              % (name, holds, raised))
        refusals[name] = raised
    for label, name in (("truncated", sorted(WEBP_FIXTURES)[-1]),
                        ("truncated lossy", sorted(WEBP_LOSSY_FIXTURES)[-1])):
        with open(os.path.join(folder, name), "rb") as f:
            blob = f.read()
        try:
            webp_decode_native(blob[: len(blob) // 2])
            truncated = None
        except OSError as e:
            truncated = str(e)
        check(truncated is not None, "ortho-webp (f): a %s file did not raise OSError" % label)
        refusals[label] = truncated
    print("ortho-webp (f): %s [%s]" % ("; ".join("%s: %s" % kv for kv in refusals.items()), card))
    return len(recorded["decoded"]) + len(recorded["lossy"]), refusals, chunks


def webp_spy():
    """A call_spy over the native WebP codec and every other decoder a
    GeoTIFF or a tile pyramid could reach."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.io import geotiff, png

    return call_spy([(native, "webp_decode_native"), (native, "webp_encode_native"),
                     (native, "jpeg_decode_native"), (native, "tiff_decode_native"),
                     (geotiff, "_lzw_decode"), (geotiff, "_packbits_decode"),
                     (png, "decode_png_bytes")])


class window_check:
    """While installed, every window the port's GeoTIFF reader returns at
    level 0 of ``path`` is held to ``pixels`` (h, w, 3): its count and the
    windows that differ."""

    def __init__(self, path, pixels):
        self.path, self.pixels = path, pixels
        self.windows, self.cells, self.differ = 0, 0, []
        self._lock = threading.Lock()

    def __enter__(self):
        from dask_geomodeling_tpu_torch.io import geotiff

        self._raw = raw = geotiff.read_geotiff_window
        height, width = self.pixels.shape[:2]

        def checked(path, row0, row1, col0, col1, level=0):
            data = raw(path, row0, row1, col0, col1, level=level)
            if level == 0 and os.path.abspath(path) == os.path.abspath(self.path):
                r0 = min(max(int(row0), 0), height)
                c0 = min(max(int(col0), 0), width)
                bands, h, w = data.array.shape
                want = self.pixels[r0 : r0 + h, c0 : c0 + w].transpose(2, 0, 1)
                same = want.shape == data.array.shape and np.array_equal(want, data.array)
                with self._lock:
                    self.windows += 1
                    self.cells += h * w
                    if not same:
                        self.differ.append((row0, row1, col0, col1))
            return data

        geotiff.read_geotiff_window = checked
        return self

    def __exit__(self, *exc):
        from dask_geomodeling_tpu_torch.io import geotiff

        geotiff.read_geotiff_window = self._raw
        return False


def rewrite_tiles_as_webp(path, rgba_tile=0):
    """Every PNG tile of the GeoPackage or MBTiles file at ``path``
    re-encoded as lossless WebP by the port's encoder (RGB; the
    ``rgba_tile``-th as RGBA, its alpha below 255 in a corner, which the
    readers drop as Pillow's conversion does), each new tile decoded back
    to the pixels written.  Returns the tiles rewritten."""
    import sqlite3

    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.native import webp_decode_native, webp_encode_native

    con = sqlite3.connect(path)
    try:
        tables = [row[0] for row in con.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'")]
        table = "tiles" if "tiles" in tables else con.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type = 'tiles'").fetchone()[0]
        rows = con.execute("SELECT rowid, tile_data FROM %s ORDER BY rowid" % table).fetchall()
        for k, (rowid, blob) in enumerate(rows):
            array, _ = decode_png_bytes(blob)
            pixels = np.ascontiguousarray(array[:3].transpose(1, 2, 0))
            if k == rgba_tile:
                alpha = np.full(pixels.shape[:2], 255, np.uint8)
                alpha[:16, :16] = 128
                pixels = np.ascontiguousarray(np.dstack([pixels, alpha]))
            tile = webp_encode_native(pixels)
            check(np.array_equal(webp_decode_native(tile), pixels),
                  "ortho-webp (c): a %s tile does not decode to the pixels written"
                  % ("RGBA" if pixels.shape[2] == 4 else "RGB"))
            con.execute("UPDATE %s SET tile_data = ? WHERE rowid = ?" % table, (tile, rowid))
        if "metadata" in tables:
            con.execute("UPDATE metadata SET value = 'webp' WHERE name = 'format'")
        con.commit()
    finally:
        con.close()
    return len(rows)


def write_webp_layout(path, pixels, geo_transform, tile=ORTHO_WEBP_LAYOUT_TILE):
    """The (h, w, 3) RGB ``pixels`` as GDAL writes COMPRESS=WEBP
    WEBP_LOSSLESS=YES: tile^2 tiles, contiguous samples (PlanarConfig 1),
    Photometric RGB, each tile one lossless WebP of its three bands (edge
    tiles padded by repeating the last row and column) from the port's
    encoder on its codec pool.  Returns the chunks' bytes in all."""
    from dask_geomodeling_tpu_torch.io.geotiff import _map_chunks
    from dask_geomodeling_tpu_torch.native import webp_encode_native

    height, width = pixels.shape[:2]
    corners = [(row, col) for row in range(0, height, tile) for col in range(0, width, tile)]

    def encode(corner):
        row, col = corner
        piece = pixels[row : row + tile, col : col + tile]
        if piece.shape[:2] != (tile, tile):
            piece = np.pad(piece, ((0, tile - piece.shape[0]), (0, tile - piece.shape[1]), (0, 0)),
                           mode="edge")
        return webp_encode_native(piece)

    chunks = _map_chunks(encode, corners)
    write_webp_chunks_layout(path, chunks, (height, width), 3, geo_transform, tile)
    return sum(len(c) for c in chunks)


def write_webp_chunks_layout(path, chunks, shape, bands, geo_transform,
                             tile=ORTHO_WEBP_LAYOUT_TILE):
    """A (height, width) = ``shape`` GeoTIFF of ``bands`` (3: RGB, 4: RGBA,
    its alpha an unassociated extra sample) in GDAL's COMPRESS=WEBP layout:
    tile^2 tiles, contiguous samples, Photometric RGB, ``chunks`` the WebP
    files of the tiles in row-major order."""
    height, width = shape
    tags = [(256, "I", [width]), (257, "I", [height]), (258, "H", [8] * bands),
            (259, "H", [50001]), (262, "H", [2]), (277, "H", [bands]), (284, "H", [1]),
            (322, "H", [tile]), (323, "H", [tile]), (339, "H", [1] * bands)]
    if bands == 4:
        tags.append((338, "H", [2]))
    write_tiff_layout(path, tags, chunks, geo_transform, "EPSG:28992", tiled=True)


def sampled_chunk_shares(path, pixels, count=ORTHO_WEBP_SAMPLED_CHUNKS, tile=ORTHO_TILE):
    """The WebP and the deflate (zlib level 6, the writer's) bytes of
    ``count`` chunks spread over a planar tiled file, each as a share of
    the chunks' raw bytes: deflate of the same band tiles in memory."""
    from dask_geomodeling_tpu_torch.io.geotiff import _TILE_BYTE_COUNTS, _open_tiff

    f, _, tags = _open_tiff(path)
    f.close()
    sizes = tags[_TILE_BYTE_COUNTS]
    height, width = pixels.shape[:2]
    tiles_y, tiles_x = -(-height // tile), -(-width // tile)
    picks = np.linspace(0, len(sizes) - 1, min(count, len(sizes))).round().astype(int)
    webp = deflate = raw = 0
    for index in picks:
        band, rest = divmod(int(index), tiles_y * tiles_x)
        ty, tx = divmod(rest, tiles_x)
        chunk = np.zeros((tile, tile), np.uint8)
        piece = pixels[ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile, band]
        chunk[: piece.shape[0], : piece.shape[1]] = piece
        webp += int(sizes[index])
        deflate += len(zlib.compress(chunk.tobytes(), 6))
        raw += chunk.size
    return webp / raw, deflate / raw, len(picks)


def windowed_webp_read(label, device, path, truth, px, sampled_tiles):
    """build_ortho_view over the px^2 RGB WebP GeoTIFF at ``path`` by window
    (ortho-jpeg (a)'s lowered limit) through check_algebra_path: every
    decoded window equal to ``truth`` (window_check), ``sampled_tiles``
    tiles bitwise to compute_host, only the native WebP decoder running
    (no encode), the Gaussian launched; its first frames and result in
    "gaussians" (a gaussian_calls).  Returns the numbers."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import pipeline

    pipeline.clear_read_cache()
    view, smooth = build_ortho_view(path)
    source = smooth.args[0].args[1].args[0]
    request = ortho_request(px)
    limit = {"geomodeling.windowed-read-limit": min(
        ORTHO_WINDOW_LIMIT, config.get("geomodeling.windowed-read-limit"))}
    native.reset_counts()
    launches = cuda_stencils.launches
    phases, gaussians = {}, gaussian_calls()
    with config.set(limit), webp_spy() as spy, window_check(path, truth) as windows:
        check(np.dtype(source.info.dtype) == np.uint8 and source.info.bands == 3
              and (source.info.width, source.info.height) == (px, px)
              and source._file_read_plan(request) is not None,
              "%s: info %r, or the read is not windowed" % (label, source.info))
        host_rate, _ = check_algebra_path(
            label, device, view, request, "nearest", (request["bbox"][0], request["bbox"][3]),
            share=0.0, sampled_tiles=sampled_tiles, first_run=(gaussians, phases), routed=False)
    decodes = dict(native.counts)
    others = {name: spy.calls[name] for name in spy.calls if name != "webp_decode_native"}
    check(decodes["webp_decodes"] > 0 and spy.calls["webp_decode_native"]
          == decodes["webp_decodes"] and not any(others.values()),
          "%s: %r native decodes, other codec calls %r" % (label, decodes, others))
    check(windows.windows > 0 and not windows.differ,
          "%s: %d of %d windows differ from the pixels" % (label, len(windows.differ),
                                                           windows.windows))
    launches = cuda_stencils.launches - launches
    check(launches > 0, "%s: the Gaussian did not launch" % label)
    seconds = spy.seconds["webp_decode_native"]
    return dict(first_phases_s=phases, host_mpx_per_s=host_rate,
                native_decodes=decodes["webp_decodes"], decoded_mb=decodes["webp_bytes"] / 1e6,
                decode_s=seconds, decode_mb_per_s=decodes["webp_bytes"] / 1e6 / seconds,
                most_decodes_at_once=spy.most["webp_decode_native"],
                windows_checked=windows.windows, window_cells=windows.cells,
                gaussian_launches=launches, gaussians=gaussians,
                gaussian_dtype=str(gaussians.first[0].dtype).replace("torch.", ""))


def check_ortho_webp(card, device, folder, pixels=None, px=ORTHO_PX, sub_px=ORTHO_SUB_PX,
                     sampled_tiles=ORTHO_SAMPLED):
    """The ortho-webp phase.  (e) and (f) check_webp_fixtures first.  (a)
    ``pixels`` (ortho_pixels(px, px), drawn here when not given) written by
    the port's write_geotiff(compress="webp", tiled, 512^2 tiles): one
    native lossless encode a band tile, the file's share of the raw bytes
    and, on sampled_chunk_shares' chunks, WebP's against deflate's.  (b)
    build_ortho_view at the file's grid by window (ortho-jpeg (a)'s
    lowered limit) through check_algebra_path: every decoded window equal
    to the pixels (window_check), ``sampled_tiles`` tiles bitwise to
    compute_host, only the native WebP decoder running, the Gaussian's
    first frames torch.equal to its plain version.  (c) the first
    ``sub_px``^2 as a GeoPackage of 256^2 WebP tiles in RD New (one RGBA)
    and as zoom-18 MBTiles in EPSG:3857 (rewrite_tiles_as_webp), each
    asked in RD New at ``sub_px``^2: every tile of the answer bitwise to
    compute_host.  (d) the sub-area as a contiguous RGB WebP GeoTIFF
    (write_webp_layout) read whole and by window, equal to the pixels.
    Returns (launches, numbers, the Gaussian's kernel records on the
    card); removes its files."""
    from dask_geomodeling_tpu_torch import native
    from dask_geomodeling_tpu_torch.io.geotiff import (
        read_geotiff, read_geotiff_window, write_geotiff,
    )
    from dask_geomodeling_tpu_torch.io.gpkg_raster import write_gpkg_raster
    from dask_geomodeling_tpu_torch.io.mbtiles import write_mbtiles
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime import pipeline

    phase_t0 = time.perf_counter()
    numbers = {}
    cuda_stencils.reset_launches()
    numbers["fixture_hashes"], numbers["refusals"], lossy_chunks = check_webp_fixtures(card)

    # (a) the orthophoto as a WebP GeoTIFF
    t0 = time.perf_counter()
    if pixels is None:
        pixels = ortho_pixels(px, px)
    numbers["draw_s"] = time.perf_counter() - t0
    path = os.path.join(folder, "ortho_webp.tif")
    native.reset_counts()
    t0 = time.perf_counter()
    with webp_spy() as spy:
        write_geotiff(path, pixels.transpose(2, 0, 1), ortho_geo_transform(), "EPSG:28992",
                      None, compress="webp", tiled=True, tile_size=ORTHO_TILE)
    numbers["write_s"] = time.perf_counter() - t0
    encodes = native.counts["webp_encodes"]
    expected = 3 * (-(-px // ORTHO_TILE)) ** 2
    check(encodes == expected == spy.calls["webp_encode_native"],
          "ortho-webp (a): %d native encodes for %d band tiles" % (encodes, expected))
    size = os.path.getsize(path)
    webp_share, deflate_share, sampled = sampled_chunk_shares(path, pixels)
    check(webp_share < deflate_share, "ortho-webp (a): WebP keeps %.4f of %d sampled chunks' "
          "bytes, deflate %.4f" % (webp_share, sampled, deflate_share))
    encode_s = spy.seconds["webp_encode_native"]
    numbers.update(webp_mb=size / 1e6, file_share=size / pixels.size, tiles_encoded=encodes,
                   encode_s=encode_s, encode_mb_per_s=pixels.size / 1e6 / encode_s,
                   most_encodes_at_once=spy.most["webp_encode_native"],
                   sampled_webp_share=webp_share, sampled_deflate_share=deflate_share)
    print("ortho-webp (a): the %d^2 RGB orthophoto of %.2f m written as a WebP GeoTIFF "
          "(lossless, %d^2 band tiles) by %d native encodes in %.2f s (%.1f MB/s a thread, up "
          "to %d at once): %.1f MB, %.4f of the raw bytes; on %d sampled chunks WebP %.4f, "
          "deflate %.4f [%s]" % (
              px, ORTHO_CELL, ORTHO_TILE, encodes, numbers["write_s"],
              numbers["encode_mb_per_s"], numbers["most_encodes_at_once"], size / 1e6,
              numbers["file_share"], sampled, webp_share, deflate_share, card))

    # (b) by window
    numbers.update(windowed_webp_read("ortho-webp (b)", device, path, pixels, px, sampled_tiles))
    gaussians = numbers.pop("gaussians")
    print("ortho-webp (b): %d native WebP decodes, %.1f MB in %.3f s summed over threads "
          "(%.1f MB/s a thread), at most %d at once; no other decoder; %d windows (%d cells) "
          "equal to the pixels written; first run %s; Gaussian %d launches on %s frames [%s]"
          % (numbers["native_decodes"], numbers["decoded_mb"], numbers["decode_s"],
             numbers["decode_mb_per_s"], numbers["most_decodes_at_once"],
             numbers["windows_checked"], numbers["window_cells"],
             ", ".join("%s %.4f s" % kv for kv in numbers["first_phases_s"].items()),
             cuda_stencils.launches, numbers["gaussian_dtype"], card))
    numbers["gaussian_launches_b"] = cuda_stencils.launches
    timed = [plain_gaussian_check("ortho-webp (b)", gaussians, gaussian_blur_reference)]
    os.remove(path)

    # (c) the pyramids over the first sub_px^2, every tile of each answer
    sub = np.ascontiguousarray(pixels[:sub_px, :sub_px])
    del pixels
    sub_request = ortho_request(sub_px)
    all_tiles = (-(-sub_px // TILE)) ** 2
    gpkg = os.path.join(folder, "ortho_webp.gpkg")
    write_gpkg_raster(gpkg, sub.transpose(2, 0, 1), ortho_geo_transform(),
                      projection="EPSG:28992", tile_size=ORTHO_PYRAMID_TILE)
    rewritten = {"gpkg": rewrite_tiles_as_webp(gpkg)}
    merc_gt, merc_w, merc_h = mercator_box(sub_request, ORTHO_PYRAMID_ZOOM, ORTHO_PYRAMID_TILE)
    mbt = os.path.join(folder, "ortho_webp.mbtiles")
    write_mbtiles(mbt, ortho_pixels(merc_w, merc_h, seed=49).transpose(2, 0, 1), merc_gt,
                  projection="EPSG:3857", name="ortho", tile_size=ORTHO_PYRAMID_TILE)
    rewritten["mbtiles"] = rewrite_tiles_as_webp(mbt)
    pyramids = {}
    for label, pyramid in (("gpkg", gpkg), ("mbtiles", mbt)):
        pipeline.clear_read_cache()
        native.reset_counts()
        t0 = time.perf_counter()
        with webp_spy() as spy:
            pyramid_view, _ = build_ortho_view(pyramid)
            check_algebra_path("ortho-webp (c) " + label, device, pyramid_view, sub_request,
                               "nearest", (sub_request["bbox"][0], sub_request["bbox"][3]),
                               share=0.0, sampled_tiles=all_tiles, routed=False)
        check(native.counts["webp_decodes"] >= rewritten[label] and not spy.calls["decode_png_bytes"],
              "ortho-webp (c) %s: %d native decodes of %d tiles, %d PNG decodes"
              % (label, native.counts["webp_decodes"], rewritten[label],
                 spy.calls["decode_png_bytes"]))
        pyramids[label] = dict(tiles=rewritten[label], decodes=native.counts["webp_decodes"],
                               decode_s=spy.seconds["webp_decode_native"],
                               seconds=time.perf_counter() - t0)
    numbers["pyramids"] = pyramids
    print("ortho-webp (c): a GeoPackage of %d (one RGBA) and a zoom-%d MBTiles of %d 256^2 "
          "WebP tiles, each tile decoding to the pixels written, read whole (%s) and asked in "
          "RD New at %d^2: every tile bitwise to compute_host [%s]" % (
              rewritten["gpkg"], ORTHO_PYRAMID_ZOOM, rewritten["mbtiles"],
              ", ".join("%s %d decodes in %.3f s" % (k, v["decodes"], v["decode_s"])
                        for k, v in pyramids.items()), sub_px, card))
    for name in (gpkg, mbt):
        os.remove(name)

    # (d) GDAL's layout: contiguous RGB WebP tiles
    layout = os.path.join(folder, "ortho_webp_rgb.tif")
    write_webp_layout(layout, sub, ortho_geo_transform())
    pipeline.clear_read_cache()
    whole = read_geotiff(layout)
    check(whole.array.shape == (3, sub_px, sub_px)
          and np.array_equal(whole.array, sub.transpose(2, 0, 1)),
          "ortho-webp (d): the contiguous RGB file reads otherwise than the pixels written")
    windows_d = [(0, 1, 0, 1), (100, 613, 250, 1031), (sub_px - 300, sub_px, 7, sub_px)]
    for row0, row1, col0, col1 in windows_d:
        window = read_geotiff_window(layout, row0, row1, col0, col1)
        check(np.array_equal(window.array, sub[row0:row1, col0:col1].transpose(2, 0, 1)),
              "ortho-webp (d): the window %r differs" % ((row0, row1, col0, col1),))
    os.remove(layout)
    print("ortho-webp (d): a contiguous RGB WebP GeoTIFF of %d^2 (GDAL's layout) read whole "
          "and in %d windows, equal to the pixels [%s]" % (sub_px, len(windows_d), card))
    del sub
    pipeline.clear_read_cache()

    # (g) lossy: GDAL's COMPRESS=WEBP default, from the checked chunks
    numbers["lossy"] = check_ortho_lossy(card, device, folder, lossy_chunks, px=px,
                                         sampled_tiles=sampled_tiles)
    pipeline.clear_read_cache()
    path_launches = {"gaussian_blur": cuda_stencils.launches,
                     "moving_max": cuda_stencils.moving_max_launches}
    kernels = [dict(time_gaussian(planes, sigma), max_abs_err=err, path=label)
               for label, planes, sigma, err in timed if planes.is_cuda]
    del timed
    numbers["phase_s"] = time.perf_counter() - phase_t0
    print("ortho-webp: Gaussian %d launches on the path; the phase %.2f s [%s]"
          % (path_launches["gaussian_blur"], numbers["phase_s"], card))
    return path_launches, numbers, kernels


def check_ortho_lossy(card, device, folder, chunks, px=ORTHO_PX, sampled_tiles=ORTHO_SAMPLED):
    """ortho-webp (g): a px^2 RGB lossy WebP GeoTIFF in GDAL's layout
    (write_webp_chunks_layout: 512^2 contiguous tiles, ortho-lossy's four
    RGB chunks repeated, at ortho-jpeg's geo transform) under
    build_ortho_view by window through check_algebra_path: every decoded
    window equal to the truth assembled from ``chunks`` (their (bytes,
    hash-checked array) by name, check_webp_fixtures'), ``sampled_tiles``
    tiles bitwise to compute_host, only the native WebP decoder running,
    the Gaussian's first frames torch.equal to its plain version; then a
    4-band file of the RGBA chunk read whole and by window, equal to its
    array.  Returns the numbers; removes its files."""
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff, read_geotiff_window
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime import pipeline

    t0 = time.perf_counter()
    tile = ORTHO_WEBP_LAYOUT_TILE
    quadrant = {corner: chunks[name] for name, corner in ORTHO_LOSSY_CHUNKS.items()
                if name != ORTHO_LOSSY_ALPHA}
    block = np.concatenate([np.concatenate([quadrant[(r, 0)][1], quadrant[(r, 1)][1]], axis=1)
                            for r in (0, 1)], axis=0)
    truth = np.tile(block, (px // (2 * tile), px // (2 * tile), 1))
    n = px // tile
    layout = [quadrant[(ty % 2, tx % 2)][0] for ty in range(n) for tx in range(n)]
    path = os.path.join(folder, "ortho_lossy.tif")
    write_webp_chunks_layout(path, layout, (px, px), 3, ortho_geo_transform())
    numbers = {"file_mb": os.path.getsize(path) / 1e6, "chunks": len(layout)}
    numbers.update(windowed_webp_read("ortho-webp (g)", device, path, truth, px, sampled_tiles))
    del truth
    plain_gaussian_check("ortho-webp (g)", numbers.pop("gaussians"), gaussian_blur_reference)
    os.remove(path)
    # the RGBA chunk as a 4-band file: its alpha the fourth band
    rgba_blob, rgba = chunks[ORTHO_LOSSY_ALPHA]
    rgba_path = os.path.join(folder, "ortho_lossy_rgba.tif")
    write_webp_chunks_layout(rgba_path, [rgba_blob], (tile, tile), 4, ortho_geo_transform())
    pipeline.clear_read_cache()
    whole = read_geotiff(rgba_path)
    check(whole.array.shape == (4, tile, tile) and np.array_equal(whole.array,
                                                                  rgba.transpose(2, 0, 1)),
          "ortho-webp (g): the 4-band file reads otherwise than its chunk")
    for row0, row1, col0, col1 in [(0, 1, 0, 1), (100, 413, 37, 500), (tile - 200, tile, 0, tile)]:
        window = read_geotiff_window(rgba_path, row0, row1, col0, col1)
        check(np.array_equal(window.array, rgba[row0:row1, col0:col1].transpose(2, 0, 1)),
              "ortho-webp (g): the 4-band window %r differs" % ((row0, row1, col0, col1),))
    os.remove(rgba_path)
    pipeline.clear_read_cache()
    numbers["phase_s"] = time.perf_counter() - t0
    print("ortho-webp (g): a %d^2 RGB lossy WebP GeoTIFF (GDAL's COMPRESS=WEBP default: quality "
          "%d, %d^2 contiguous tiles, %.1f MB) by window: %d native decodes, %.1f MB in %.3f s "
          "summed over threads (%.1f MB/s a thread), at most %d at once; no other decoder; %d "
          "windows (%d cells) equal to the truth; first run %s; Gaussian %d launches; the "
          "4-band file of the RGBA chunk whole and in 3 windows equal to it; %.2f s [%s]"
          % (px, ORTHO_LOSSY_QUALITY, tile, numbers["file_mb"], numbers["native_decodes"],
             numbers["decoded_mb"], numbers["decode_s"], numbers["decode_mb_per_s"],
             numbers["most_decodes_at_once"], numbers["windows_checked"],
             numbers["window_cells"],
             ", ".join("%s %.4f s" % kv for kv in numbers["first_phases_s"].items()),
             numbers["gaussian_launches"], numbers["phase_s"], card))
    return numbers


def plain_gaussian_check(label, gaussians, reference):
    """The first Gaussian of a path (a gaussian_calls) torch.equal to its
    plain version on the same frames; returns (label, planes, sigma,
    max_abs_err) for its kernel record."""
    import torch

    planes, result, sigma, fill = gaussians.first
    want = reference(planes, *sigma, fill)
    check(torch.equal(result, want), "gaussian_blur differs from its plain version on the %s "
          "path's frames" % label)
    err = float((result - want).abs().max())
    print("kernel check: gaussian_blur %s batch %s %s sigma=(%.6f, %.6f), the path's own "
          "frames: equal=True max_abs_err=%r" % (label, tuple(planes.shape),
                                                   str(planes.dtype).replace("torch.", ""),
                                                   sigma[0], sigma[1], err))
    return label, planes, sigma, err


class numpy_scanline:
    """While installed, polygons burn with the numpy scanline: the native
    rasterizer is bypassed (geo/rasterize.py:_burn_native answers False)."""

    def __enter__(self):
        from dask_geomodeling_tpu_torch.geo import rasterize

        self.native = rasterize._burn_native
        rasterize._burn_native = lambda *args: False
        return self

    def __exit__(self, *exc):
        from dask_geomodeling_tpu_torch.geo import rasterize

        rasterize._burn_native = self.native
        return False


def check_rasterize_burns(card, view, request):
    """The rasterize path's Rasterize node (``view``'s first argument) on
    each of its tiles on the host: the native burn bitwise equal to the
    numpy scanline's, the native burn run and the scanline not; returns
    (tiles, native s, numpy s)."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    block = view.args[0]
    tiles, _ = tile_requests(request, TILE)
    native_s = numpy_s = 0.0
    for k, tile in enumerate(tiles):
        graph, name = block.get_compute_graph(**tile)
        with native_spy() as spy:
            t0 = time.perf_counter()
            burned = compute_host(graph, name)
            native_s += time.perf_counter() - t0
        check_native_only("rasterize tile %d" % k, spy)
        check(spy.calls["rasterize_native"] > 0, "rasterize tile %d: no native burn" % k)
        with numpy_scanline():
            t0 = time.perf_counter()
            plain = compute_host(graph, name)
            numpy_s += time.perf_counter() - t0
        check(burned["values"].dtype == plain["values"].dtype
              and np.array_equal(burned["values"], plain["values"]),
              "rasterize tile %d: the native burn differs from the numpy scanline" % k)
    print("rasterize path: on each of its %d tiles the native burn equals the numpy scanline's "
          "bitwise; Rasterize on the host %.3f s native, %.3f s numpy scanline [%s]"
          % (len(tiles), native_s, numpy_s, card))
    return len(tiles), native_s, numpy_s


class PhaseClock:
    """Seconds spent inside chosen functions while it is installed: each
    (owner, attribute) is replaced by a wrapper that adds its wall time
    to its phase (a call nested in a call of the same phase counts once).
    It never synchronises the card: a phase whose result reaches the host
    waits for the card there, as it does without the clock."""

    def __init__(self, patches):
        self.patches = patches
        self.seconds = {phase: 0.0 for _, _, phase in patches}
        self.calls = {phase: 0 for _, _, phase in patches}
        self._depth = {phase: 0 for _, _, phase in patches}
        self._saved = []

    def _wrap(self, func, phase):
        import functools

        @functools.wraps(func)
        def timed(*args, **kwargs):
            self._depth[phase] += 1
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                self._depth[phase] -= 1
                if self._depth[phase] == 0:
                    self.seconds[phase] += time.perf_counter() - t0
                    self.calls[phase] += 1

        return timed

    def __enter__(self):
        for owner, attribute, phase in self.patches:
            raw = owner.__dict__[attribute] if isinstance(owner, type) else getattr(owner, attribute)
            self._saved.append((owner, attribute, raw))
            if isinstance(raw, staticmethod):
                setattr(owner, attribute, staticmethod(self._wrap(raw.__func__, phase)))
            else:
                setattr(owner, attribute, self._wrap(raw, phase))
        return self

    def __exit__(self, *exc):
        for owner, attribute, raw in reversed(self._saved):
            setattr(owner, attribute, raw)
        self._saved = []
        return False


def export_clock():
    """A PhaseClock over the phases of a geometry export: the vector file
    reads (whole-file parses and R-tree reads, cache hits included), the
    raster window reads, the compute_torch run, AggregateRaster's device
    plane (label planes and statistics, ending in their copy to the
    host), the sinks' writes and the merge.  Planning is the export's time outside the run and the
    merge; it holds the extent requests and the raster window reads."""
    from dask_geomodeling_tpu_torch.geometry import aggregate
    from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.runtime import executor, pipeline

    return PhaseClock([
        (pipeline, "read_vector_cached", "vector read"),
        (vectorfile, "_read_gpkg", "vector read"),
        (pipeline, "read_geotiff_window_cached", "raster reads"),
        (pipeline, "read_geotiff_cached", "raster reads"),
        (executor, "compute_torch", "run"),
        (aggregate, "_aggregate_on_device", "device plane"),
        (GeometryFileSink, "process", "sink writes"),
        (GeometryFileSink, "merge_files", "merge"),
    ])


def frame_rows(frame):
    """{fid: {column: cell}} of a frame read back from a file, the
    geometry as WKB."""
    rows = {}
    for fid, row in frame.iterrows():
        rows[fid] = {k: (v.wkb if k == "geometry" and v is not None else v)
                     for k, v in row.items()}
    return rows


def compare_heights(label, port_rows, host_rows, mean_ulps=None, rounded=("h_mean",)):
    """The export's rows against the host's: the same fids, every column
    bitwise but the ``rounded`` ones (rounded means, and what is derived
    from them), where a row may differ only if its unrounded means are
    within one float32 ulp (``mean_ulps(fids)`` gives them); returns the
    differing rows' fids."""
    check(sorted(port_rows) == sorted(host_rows), "%s: the fids differ from the host's" % label)
    differ = []
    for fid, host in host_rows.items():
        port = port_rows[fid]
        check(sorted(port) == sorted(host), "%s: the columns differ" % label)
        for column, value in host.items():
            if repr(port[column]) == repr(value):
                continue
            check(column in rounded, "%s: fid %s %s %r differs from the host's %r"
                  % (label, fid, column, port[column], value))
            if fid not in differ:
                differ.append(fid)
    if differ:
        ulps = mean_ulps(differ)
        check(max(ulps) <= 1, "%s: a mean of %d rows differs by more than one float32 ulp "
              "before rounding" % (label, len(differ)))
    return differ


def mean_ulps(mean_views, request, device):
    """``ulps(fids)``: the float32 ulps between the card's and the host's
    unrounded means of ``fids``, over each AggregateRaster of
    ``mean_views`` that holds the fid, on ``request``."""
    from dask_geomodeling_tpu_torch import compute_host

    def ulps(fids):
        means = [(mean_view.get_data(device=device, **request)["features"],
                  compute_host(*mean_view.get_compute_graph(**request))["features"])
                 for mean_view in mean_views]
        out = []
        for fid in fids:
            found = False
            for card_mean, host_mean in means:
                at = card_mean.index.values == fid
                host_at = host_mean.index.values == fid
                check(at.any() == host_at.any(), "fid %s has a mean on one of the card and the "
                      "host only" % fid)
                if at.any():
                    found = True
                    a = np.float32(card_mean["agg"].values[at][0])
                    b = np.float32(host_mean["agg"].values[host_at][0])
                    out.append(abs(int(a.view(np.int32)) - int(b.view(np.int32))))
            check(found, "fid %s differs from the host's, and no mean holds it" % fid)
        return out
    return ulps


def geojson_equal(ours, theirs, differ, rounded):
    """Whether the GeoJSON file ``ours`` is byte-identical to ``theirs``
    once the ``rounded`` properties of the features ``differ`` (the rows
    compare_heights found within one ulp) take their values from
    ``theirs``: every other byte must be the same."""
    with open(theirs, "rb") as f:
        host_bytes = f.read()
    with open(ours, "rb") as f:
        port_bytes = f.read()
    if not differ:
        return port_bytes == host_bytes
    ids = {fid.item() if hasattr(fid, "item") else fid for fid in differ}
    host = {feature["id"]: feature for feature in json.loads(host_bytes)["features"]}
    port = json.loads(port_bytes)
    for feature in port["features"]:
        if feature["id"] in ids:
            for column in rounded:
                feature["properties"][column] = host[feature["id"]]["properties"][column]
    return json.dumps(port).encode() == host_bytes


def export_block(source, extent, tile, projection, centroids):
    """The block of 3 x 3 of ``tile`` m export tiles at the middle of
    ``extent``, each the same square as the whole export's: (its box, the
    GeometryTiler's (source, request) pieces over it, the mask of the
    ``centroids`` (n, 2) strictly inside one of them)."""
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryTiler

    x1, y1, x2, y2 = extent
    n_cols, n_rows = -(-(x2 - x1) // tile), -(-(y2 - y1) // tile)
    step_x, step_y = (x2 - x1) / n_cols, (y2 - y1) / n_rows
    c0, r0 = max(0, n_cols // 2 - 1), max(0, n_rows // 2 - 1)
    block = box(x1 + step_x * c0, y1 + step_y * r0, x1 + step_x * min(c0 + 3, n_cols),
                y1 + step_y * min(r0 + 3, n_rows))
    block_tiles = GeometryTiler(source, tile, projection).get_sources_and_requests(
        mode="centroid", geometry=block, projection=projection)
    in_block = np.zeros(len(centroids), bool)
    for _, request in block_tiles:
        bx1, by1, bx2, by2 = request["geometry"].bounds
        in_block |= ((centroids[:, 0] > bx1) & (centroids[:, 0] < bx2)
                     & (centroids[:, 1] > by1) & (centroids[:, 1] < by2))
    return block, block_tiles, in_block


def check_buildings(card, device, folder, sheet, count=BUILDINGS, tile=BUILDING_TILE,
                    sub_size=BUILDING_TILE):
    """The building-heights phase: per-building height statistics of the
    smoothed sheet, exported in tiles to a GeoPackage (to_file) over a
    block of 3 x 3 of the tiles (export_block), checked against
    compute_host and repeated through the GeoPackage's R-tree over the
    same block;
    a sub-area exported untiled as GeoJSON and as a Shapefile against the
    host's export of it.  The first export is timed under the phase
    clock alone; the device busy time and idle share come from the R-tree
    export, run under torch.profiler.  Returns ({kernel: launches of the
    first export}, the numbers)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSink
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    started = time.perf_counter()
    sheet_bbox = RasterFileSource(sheet).geometry.bounds
    t0 = time.perf_counter()
    buildings = write_buildings(folder, sheet_bbox, count)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(buildings)
    check(vectorfile.gpkg_rtree_name(buildings, "pand") == "rtree_pand_geom",
          "building-heights: the GeoPackage has no R-tree index")
    print("building-heights: %d footprints written to a GeoPackage (layer pand, EPSG:28992, "
          "with its gpkg_rtree_index) in %.2f s, %d bytes" % (count, write_s, size))
    view = build_buildings_view(buildings, sheet)
    source = view.args[0]
    mean_view = view.args[2].args[0].source  # Round(mean) -> GetSeriesBlock -> AggregateRaster
    projection = "EPSG:28992"
    pipeline.clear_read_cache()

    def synchronize():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def export(target, profiled, **geometry):
        def run():
            to_file(view, target, tile_size=tile, projection=projection, mode="centroid",
                    device=device, **geometry)

        cuda_stencils.reset_launches()
        with export_clock() as clock:
            if profiled:
                seconds, busy = device_busy_ms(run)
            else:
                synchronize()
                t0 = time.perf_counter()
                run()
                synchronize()
                seconds, busy = time.perf_counter() - t0, None
        launches = {"gaussian_blur": cuda_stencils.launches,
                    "moving_max": cuda_stencils.moving_max_launches}
        return seconds, busy, launches, clock

    target = os.path.join(folder, "heights.gpkg")
    extent = source.get_data(mode="extent", projection=projection)["extent"]
    everything = vectorfile.read_vector(buildings, layer="pand")
    centroids = np.array([g.centroid.coords[0] for g in everything.geometry.values])
    block, pieces, in_block = export_block(source, extent, tile, projection, centroids)
    export_s, _, launches, clock = export(target, profiled=False, geometry=block)
    subrequests = [request for _, request in pieces]
    exported = int(in_block.sum())
    merged = vectorfile.read_vector(target)
    phases = dict(clock.seconds)
    phases["planning"] = export_s - phases["run"] - phases["merge"]
    print("building-heights: to_file of the %d buildings of a block of %d tiles of %g m (of "
          "%d footprints): %.3f s, %.1f buildings/s, %d in the merged file [%s]" % (
              exported, len(subrequests), tile, count, export_s, exported / export_s,
              len(merged), card))
    print("building-heights: phases (s; planning holds the extent requests and the raster "
          "window reads, the run holds the device plane and the sink writes; vector reads "
          "fall in both; %d timed calls): %s" % (
              sum(clock.calls.values()), json.dumps({k: round(v, 4) for k, v in phases.items()})))
    print("building-heights: %d Gaussian launches in one export: one per tile subrequest "
          "(%d), the mean's and the p90's AggregateRaster asking their tile's raster alike, "
          "so the two share one Smooth node; %d moving-max launches"
          % (launches["gaussian_blur"], len(subrequests), launches["moving_max"]))
    check(launches["gaussian_blur"] == len(subrequests),
          "building-heights: %d Gaussian launches for %d tiles"
          % (launches["gaussian_blur"], len(subrequests)))

    # every building whose centroid lies strictly inside a tile, each once
    fids = merged.index.values.tolist()
    check(len(fids) == len(set(fids)), "building-heights: a fid is in the merged file twice")
    check(sorted(fids) == sorted(everything.index.values[in_block].tolist()),
          "building-heights: the merged file does not hold every building whose centroid "
          "lies strictly inside a tile")
    names = {"identificatie", "bouwjaar", "status", "h_mean", "h_p90", "relief", "area",
             "geometry"}
    check(set(merged.columns) == names, "building-heights: the fields are %s"
          % sorted(merged.columns))
    print("building-heights: the merged file holds all %d buildings whose centroid lies "
          "strictly inside a tile of the block (of %d), each fid once, fields %s"
          % (len(fids), count, sorted(names - {"geometry"})))

    # two tiles against compute_host: the host's partial file of the same
    # subrequest against the export's rows of those fids
    host_s = 0.0
    merged_rows = frame_rows(merged)
    host_dir = os.path.join(folder, "host_partials")
    differing = 0
    for request in (subrequests[0], subrequests[len(subrequests) // 2]):
        sink = GeometryFileSink(view, host_dir, extension="gpkg")
        t0 = time.perf_counter()
        compute_host(*sink.get_compute_graph(**request))
        host_s += time.perf_counter() - t0
        host_rows = frame_rows(vectorfile.read_vector(
            os.path.join(host_dir, tokenize(request)[:7] + ".gpkg")))
        differing += len(compare_heights(
            "building-heights tile", {fid: merged_rows[fid] for fid in host_rows if
                                      fid in merged_rows}, host_rows, mean_ulps([mean_view], request, device)))
    print("building-heights: two tiles' rows equal compute_host of their subrequests: "
          "geometry, area, h_p90 and relief bitwise, h_mean differing in %d rows (within one "
          "float32 ulp before rounding) [%s]" % (differing, card))

    # again through the GeoPackage's R-tree, over the same block
    # 1 MiB, below the 16 MiB default and the file (a smaller file: half its size)
    limit = min(1024 * 1024, size // 2)
    block_tiles = pieces
    with config.set({"geomodeling.vector-windowed-read-limit": limit}):
        pipeline.clear_read_cache()
        rtree_target = os.path.join(folder, "heights_rtree.gpkg")
        rtree_s, busy_ms, rtree_launches, rtree_clock = export(rtree_target, profiled=True,
                                                               geometry=block)
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / rtree_s
    rtree_rows = frame_rows(vectorfile.read_vector(rtree_target))
    check(sorted(rtree_rows) == sorted(everything.index.values[in_block].tolist()),
          "building-heights: the R-tree export holds other features than those of its tiles")
    rounding = 0
    for fid, row in merged_rows.items():
        if fid not in rtree_rows:
            continue
        for column, value in row.items():
            if column == "h_mean" and repr(rtree_rows[fid][column]) != repr(value):
                rounding += 1
                check(abs(rtree_rows[fid][column] - value) <= 0.0100001,
                      "building-heights: h_mean of the R-tree export")
            elif column != "h_mean":
                check(repr(rtree_rows[fid][column]) == repr(value),
                      "building-heights: the R-tree export differs in %s" % column)
    check(rtree_clock.calls["vector read"] >= len(block_tiles),
          "building-heights: the R-tree export read the file %d times"
          % rtree_clock.calls["vector read"])
    print("building-heights: through the R-tree (geomodeling.vector-windowed-read-limit "
          "%d bytes) over %d of the tiles: %d vector reads, %d features, each the first "
          "export's, h_mean differing in %d rows; %.3f s under torch.profiler, %d Gaussian "
          "launches; device busy %s, idle share %s [%s]" % (
              limit, len(block_tiles), rtree_clock.calls["vector read"], len(rtree_rows),
              rounding, rtree_s, rtree_launches["gaussian_blur"],
              "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
              "not measured" if idle is None else "%.4f" % idle, card))

    # a sub-area exported untiled as GeoJSON and as a Shapefile
    x1, y1, x2, y2 = extent
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    sub = box(cx - sub_size / 2, cy - sub_size / 2, cx + sub_size / 2, cy + sub_size / 2)
    sub_request = dict(mode="centroid", geometry=sub, projection=projection)
    for ext in ("geojson", "shp"):
        ours = os.path.join(folder, "sub." + ext)
        to_file(view, ours, device=device, **sub_request)
        host_target = os.path.join(folder, "host_sub." + ext)
        sink_dir = os.path.join(folder, "host_sub_" + ext)
        t0 = time.perf_counter()
        compute_host(*GeometryFileSink(view, sink_dir, extension=ext).get_compute_graph(
            **sub_request))
        GeometryFileSink.merge_files(sink_dir, host_target)
        host_s += time.perf_counter() - t0
        port_rows = frame_rows(vectorfile.read_vector(ours))
        differ = compare_heights("building-heights sub-area " + ext, port_rows,
                                 frame_rows(vectorfile.read_vector(host_target)),
                                 mean_ulps([mean_view], sub_request, device))
        if ext == "geojson":
            check(geojson_equal(ours, host_target, differ, ("h_mean",)),
                  "building-heights: the GeoJSON differs from the host's beyond h_mean of "
                  "%d rows" % len(differ))
        print("building-heights: a %g m sub-area exported untiled as %s: %d buildings, equal "
              "to the host's export (h_mean differing in %d rows)"
              % (sub_size, ext, len(port_rows), len(differ)))
    # the Gaussian's plane on this path: the first tile's raster request
    # and Smooth's margin
    raster_request = mean_view.get_sources_and_requests(**subrequests[0])[1][1]
    sigma = smooth_sigma(mean_view.raster, raster_request)
    margin = int(round(3 * sigma[0]))
    plane = (1, raster_request["height"] + 2 * margin, raster_request["width"] + 2 * margin)
    total_s = time.perf_counter() - started
    print("building-heights: host ground truth %.3f s (two tiles and two sub-area exports); "
          "the phase %.1f s; the Gaussian's plane %s at sigma %s [%s]"
          % (host_s, total_s, plane, sigma, card))
    return launches, dict(
        plane=plane, sigma=sigma,
        buildings=count, exported=exported, tiles=len(subrequests), export_s=export_s,
        buildings_per_s=exported / export_s, rtree_device_busy_ms=busy_ms, rtree_idle_share=idle,
        phases=phases, rtree_export_s=rtree_s, host_s=host_s, phase_s=total_s,
        h_mean_rows_differing=differing, write_s=write_s, gpkg_bytes=size)


# --- the wms-serving phase ---

#: a slippy-map client's traffic over the sheet: WMS 1.1.1 GetMap,
#: image/png, EPSG:3857, 256^2 tiles, every XYZ tile of these zooms that
#: touches the sheet's EPSG:3857 box, row-major within each zoom
WMS_ZOOMS = (14, 15, 16)
WMS_TILE = 256
WMS_ORIGIN = 20037508.342789244  # half the web Mercator world's width
#: the last zoom is cut to this many of its tile rows, the middle ones
#: (the phase's time budget: all 18 rows took 129.5 s, 9 rows 97.2 s and
#: 3 rows 52.0-75.9 s on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
#: section 4)
WMS_LAST_ZOOM_ROWS = 1
#: wms_serve.main's result cache
WMS_CACHE_BYTES = 256 * 2**20
#: tiles a layer held to compute_host, spread over the zooms
WMS_SAMPLE = 16
WMS_FEATURE_INFO = 16
WMS_THREADS = 4
WMS_CONCURRENT_TILES = 64


def wms_layers(sheet):
    """{name: (view, style, vmin, vmax)}: the layers the phase serves,
    the file-read path's view and a HillShade of the sheet."""
    from dask_geomodeling_tpu_torch.raster import HillShade, RasterFileSource, Smooth

    return {
        "ahn-smooth": (Smooth(RasterFileSource(sheet), 3), "terrain", 0.0, 10.0),
        "ahn-hillshade": (HillShade(RasterFileSource(sheet)), "gray", 0.0, 255.0),
    }


def xyz_tiles(bbox, zooms=WMS_ZOOMS, last_zoom_rows=None):
    """Every XYZ tile (z, x, y) of ``zooms`` that touches ``bbox``
    (EPSG:3857), row-major within each zoom; with ``last_zoom_rows``, only
    that many of the last zoom's rows, the middle ones."""
    tiles = []
    for z in zooms:
        size = 2 * WMS_ORIGIN / 2**z
        x0 = int(np.floor((bbox[0] + WMS_ORIGIN) / size))
        x1 = int(np.ceil((bbox[2] + WMS_ORIGIN) / size))
        y0 = int(np.floor((WMS_ORIGIN - bbox[3]) / size))
        y1 = int(np.ceil((WMS_ORIGIN - bbox[1]) / size))
        if z == zooms[-1] and last_zoom_rows is not None and last_zoom_rows < y1 - y0:
            y0 += (y1 - y0 - last_zoom_rows) // 2
            y1 = y0 + last_zoom_rows
        tiles += [(z, x, y) for y in range(y0, y1) for x in range(x0, x1)]
    return tiles


def xyz_bbox(z, x, y):
    """The EPSG:3857 box of XYZ tile (z, x, y)."""
    size = 2 * WMS_ORIGIN / 2**z
    return (x * size - WMS_ORIGIN, WMS_ORIGIN - (y + 1) * size,
            (x + 1) * size - WMS_ORIGIN, WMS_ORIGIN - y * size)


def getmap_params(layer, style, vmin, vmax, tile):
    """A slippy-map client's GetMap query of ``tile``."""
    return {"SERVICE": "WMS", "VERSION": "1.1.1", "REQUEST": "GetMap", "LAYERS": layer,
            "STYLES": style, "VMIN": repr(vmin), "VMAX": repr(vmax), "FORMAT": "image/png",
            "SRS": "EPSG:3857", "BBOX": "%r,%r,%r,%r" % xyz_bbox(*tile),
            "WIDTH": str(WMS_TILE), "HEIGHT": str(WMS_TILE)}


def tile_request(tile):
    """The get_data request a GetMap of ``tile`` makes."""
    return dict(mode="vals", bbox=xyz_bbox(*tile), height=WMS_TILE, width=WMS_TILE,
                projection="EPSG:3857", start=None)


class WMSClient:
    """The port's wms_app on wsgiref at 127.0.0.1 (a free port), served
    from a background thread; ``get`` asks from the calling thread."""

    def __init__(self):
        from wsgiref.simple_server import WSGIRequestHandler, make_server

        from dask_geomodeling_tpu_torch.ipyleaflet_plugin import wms_app

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        self.httpd = make_server("127.0.0.1", 0, wms_app, handler_class=Quiet)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d/wms?" % self.httpd.server_address[1]

    def get(self, params):
        """(status, content type, body, seconds) of one GET."""
        import urllib.error
        import urllib.request
        from urllib.parse import urlencode

        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(self.url + urlencode(params), timeout=120) as response:
                body = response.read()
                status, content_type = response.status, response.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            body, status, content_type = e.read(), e.code, e.headers["Content-Type"]
        return status, content_type, body, time.perf_counter() - t0

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def latency_numbers(seconds):
    """Tiles, p50, p99 and max ms, and tiles a second, of per-tile seconds."""
    ms = np.asarray(seconds) * 1e3
    p50, p99 = np.percentile(ms, [50, 99])
    return dict(tiles=int(ms.size), p50_ms=float(p50), p99_ms=float(p99), max_ms=float(ms.max()),
                tiles_per_s=float(ms.size / (ms.sum() / 1e3)))


def wms_pass(client, layers, tiles, label, card):
    """One pass over every tile of every layer through HTTP, layer by
    layer; returns ({layer: (PNG bytes per tile, latency numbers)},
    {kernel: its launches in the pass})."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    cuda_stencils.reset_launches()
    out = {}
    for name, (_, style, vmin, vmax) in layers.items():
        bodies, seconds = [], []
        for tile in tiles:
            status, content_type, body, s = client.get(getmap_params(name, style, vmin, vmax, tile))
            check(status == 200 and content_type == "image/png" and body[:4] == b"\x89PNG",
                  "wms-serving %s: %s tile %s answered %s %r" % (label, name, tile, status, body[:200]))
            bodies.append(body)
            seconds.append(s)
        numbers = latency_numbers(seconds)
        out[name] = (bodies, numbers)
        print("wms-serving [%s] %s %s: %d tiles, p50 %.3f ms, p99 %.3f ms, max %.3f ms, "
              "%.1f tiles/s" % (card, label, name, numbers["tiles"], numbers["p50_ms"],
                                numbers["p99_ms"], numbers["max_ms"], numbers["tiles_per_s"]))
    return out, {"gaussian_blur": cuda_stencils.launches,
                  "moving_max": cuda_stencils.moving_max_launches}


def wms_source_reach(view, request, device):
    """The output cells of ``request`` within reach of a cell where the
    view's warped source on the card differs from compute_host's (the
    cross-CRS nearest warp's residual), and the share of source cells that
    differ.  The reach is the view's own: HillShade's 3x3 window, Smooth's
    Gaussian radius; both requests' sources are grown evenly about the
    output."""
    from scipy import ndimage

    from dask_geomodeling_tpu_torch import compute_host, compute_torch
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_weights

    graph, name = view.get_compute_graph(**request)
    node = graph[name]
    host = compute_host(graph, node[1])["values"][0]
    _kept.clear()
    compute_torch(dict(graph, kept=(_keep_on_device, node[1])), "kept", device=device)
    card = _kept.pop()["values"][0].cpu().numpy()
    differ = card != host
    if host.dtype.kind == "f":
        differ &= ~(np.isnan(card) & np.isnan(host))
    if getattr(node[0], "__name__", "") == "_smooth_process":
        reach = [gaussian_weights(size / 3)[1] for size in node[2]["size"]]
    else:
        reach = [1, 1]
    if differ.any():
        differ = ndimage.binary_dilation(differ, np.ones([2 * r + 1 for r in reach], bool))
    height, width = request["height"], request["width"]
    my, mx = (differ.shape[0] - height) // 2, (differ.shape[1] - width) // 2
    return differ[my:my + height, mx:mx + width], float(np.mean(card != host))


def wms_within_limits(name, port, host, reach):
    """Whether a tile's card values meet the limits of PERF.md section 2
    beside compute_host's: outside the reach of a differing warped source
    cell, ahn-smooth bitwise and ahn-hillshade within 1 in at most 1e-3 of
    the cells; returns (ok, differing cells, differing cells outside the
    reach)."""
    differ, worst, _ = compare_cells(port, host, None)
    differ_mask = port != host
    if host.dtype.kind == "f":
        differ_mask &= ~(np.isnan(port) & np.isnan(host))
    outside = differ_mask & ~reach
    if name == "ahn-hillshade":
        off = np.abs(port.astype(np.int64) - host.astype(np.int64))
        ok = not (outside & (off > 1)).any() and outside.mean() <= STENCILS_SHARE
    else:
        ok = not outside.any()
    return ok, differ, int(np.count_nonzero(outside))


def wms_ground_truth(card, device, layers, tiles, picks, served):
    """The sampled tiles on the card against compute_host, and the served
    PNGs against the host's render of the host's values: at most 5e-4 of
    the warped source cells differ (the cross-CRS nearest warp's limit),
    the values within each view's own limit outside their reach
    (wms_within_limits), and every pixel whose value agrees coloured
    alike.  Each sampled tile is also timed in-process on both sides, the
    same way (no HTTP on either): the card's render_wms_tile of the GetMap
    (its PNG equal to the served one) and the numpy host's planning,
    compute_host, render and PNG encode, the two in turns, which one goes
    first alternating by tile.  Returns {layer: the card's and the host's
    latency numbers, the pixels and cells that differ}."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import (
        encode_tile, render_wms_tile, tile_values)

    out = {}
    for name, (view, style, vmin, vmax) in layers.items():
        card_s, host_s, pixels_off, cells_off, worst_source = [], [], 0, 0, 0.0
        hosts = []
        for turn, index in enumerate(picks):
            request = tile_request(tiles[index])
            params = {k.lower(): v for k, v in
                      getmap_params(name, style, vmin, vmax, tiles[index]).items()}
            for side in ("card", "host") if turn % 2 == 0 else ("host", "card"):
                t0 = time.perf_counter()
                if side == "card":
                    card_png = render_wms_tile(params)
                    card_s.append(time.perf_counter() - t0)
                else:
                    host = compute_host(*view.get_compute_graph(**request))
                    host_png = encode_tile(tile_values(host, WMS_TILE, WMS_TILE), style, vmin,
                                           vmax)
                    host_s.append(time.perf_counter() - t0)
            check(card_png == served[name][0][index], "wms-serving: %s tile %s rendered "
                  "in-process differs from the served one" % (name, tiles[index]))
            port = view.get_data(**request)
            check(port["values"].dtype == host["values"].dtype
                  and port["no_data_value"] == host["no_data_value"],
                  "wms-serving: %s tile %s: dtype or nodata" % (name, tiles[index]))
            a, b = port["values"][0], host["values"][0]
            hosts.append(host["values"])
            reach, source_share = wms_source_reach(view, request, device)
            worst_source = max(worst_source, source_share)
            ok, differ, outside = wms_within_limits(name, a, b, reach)
            cells_off += differ
            check(source_share <= HEADLINE_SHARE and ok,
                  "wms-serving: %s tile %s: %.3g of the warped source cells differ; %d cells "
                  "differ, %d beyond the view's limit" % (name, tiles[index], source_share,
                                                         differ, outside))
            agree = (a == b) | ((a != a) & (b != b))
            pixels = (decode_png_bytes(served[name][0][index])[0]
                      != decode_png_bytes(host_png)[0]).any(axis=0)
            pixels_off += int(np.count_nonzero(pixels))
            check(not (pixels & agree).any(), "wms-serving: %s tile %s: a pixel whose value "
                  "agrees with the host's is coloured otherwise" % (name, tiles[index]))
        paired = {"card": latency_numbers(card_s), "host": latency_numbers(host_s)}
        print("wms-serving [%s] %s in-process on %d sampled tiles (planning, values, render and "
              "PNG, no HTTP): card p50 %.3f ms, p99 %.3f ms, max %.3f ms; numpy host p50 %.3f "
              "ms, p99 %.3f ms, max %.3f ms" % (
                  card, name, len(picks), paired["card"]["p50_ms"], paired["card"]["p99_ms"],
                  paired["card"]["max_ms"], paired["host"]["p50_ms"], paired["host"]["p99_ms"],
                  paired["host"]["max_ms"]))
        print("wms-serving: %s on the card: at most %.3g of a tile's warped source cells "
              "differ, %d cells and %d pixels differ in all, none beyond the limits or where "
              "the values agree" % (name, worst_source, cells_off, pixels_off))
        out[name] = dict(paired, differing_pixels=pixels_off, differing_cells=cells_off,
                         largest_source_share=worst_source)
        if name == "ahn-hillshade":
            after, before = division_shares(view, [tile_request(tiles[i]) for i in picks],
                                            hosts, device)
            out[name].update(off_by_one_share=after, plain_division_share=before)
            print("wms-serving: ahn-hillshade's off-by-one share on the %d sampled tiles %r with "
                  "device.divide, %r with the plain division" % (len(picks), after, before))
    return out


def wms_other_requests(client, device, layers, tiles, picks, folder):
    """GetFeatureInfo at WMS_FEATURE_INFO pixels against compute_host,
    GetLegendGraphic of each style, GetCoverage of a tile of the last
    zoom against the tile's values, GetCapabilities' layers and WGS84
    boxes, and a layer JSON naming the JAX package's classes refused with
    400 without loading any module of it."""
    from xml.etree import ElementTree

    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.geo.crs import transform_extent
    from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.render import colormaps

    rng = np.random.RandomState(17)
    names = list(layers)
    explained = 0
    for k in range(WMS_FEATURE_INFO):
        name = names[k % len(names)]
        view, style, vmin, vmax = layers[name]
        col, row = rng.randint(0, WMS_TILE, 2)
        status, _, body, _ = client.get(dict(
            getmap_params(name, style, vmin, vmax, tiles[picks[k % len(picks)]]),
            REQUEST="GetFeatureInfo", QUERY_LAYERS=name, X=str(col), Y=str(row)))
        check(status == 200, "wms-serving: GetFeatureInfo answered %s %r" % (status, body[:200]))
        payload = json.loads(body)
        point = (payload["x"], payload["y"], payload["x"], payload["y"])
        host = compute_host(*view.get_compute_graph(
            mode="vals", bbox=point, width=1, height=1, projection="EPSG:3857", start=None))
        raw = host["values"][0, 0, 0]
        want = None if raw == host["no_data_value"] or not np.isfinite(raw) else raw.item()
        got = payload["value"]
        if got != want:
            reach, _ = wms_source_reach(view, dict(
                mode="vals", bbox=point, width=1, height=1, projection="EPSG:3857", start=None),
                device)
            near = name == "ahn-hillshade" and None not in (got, want) and abs(got - want) <= 1
            check(near or reach.any(), "wms-serving: GetFeatureInfo of %s at %s gave %r, the "
                  "host %r" % (name, point, got, want))
            explained += 1
    styles = sorted({style for _, style, _, _ in layers.values()})
    ramp = np.linspace(1.0, 0.0, 160)[:, None].repeat(24, axis=1)
    for style in styles:
        status, content_type, body, _ = client.get({"REQUEST": "GetLegendGraphic", "STYLES": style})
        check(status == 200 and content_type == "image/png" and np.array_equal(
            decode_png_bytes(body)[0], colormaps.apply(style, ramp).transpose(2, 0, 1)),
            "wms-serving: GetLegendGraphic of %s" % style)
    view, style, vmin, vmax = layers["ahn-smooth"]
    tile = next(t for t in tiles if t[0] == max(t[0] for t in tiles))
    status, content_type, body, _ = client.get(dict(
        getmap_params("ahn-smooth", style, vmin, vmax, tile), REQUEST="GetCoverage",
        COVERAGE="ahn-smooth", FORMAT="GeoTIFF"))
    check(status == 200 and content_type == "image/tiff", "wms-serving: GetCoverage %s" % status)
    path = os.path.join(folder, "coverage.tif")
    with open(path, "wb") as f:
        f.write(body)
    coverage = read_geotiff(path)
    expected = view.get_data(**tile_request(tile))
    check(np.array_equal(coverage.array, expected["values"])
          and coverage.no_data_value == expected["no_data_value"],
          "wms-serving: GetCoverage differs from the tile's values")
    status, _, body, _ = client.get({"SERVICE": "WMS", "REQUEST": "GetCapabilities"})
    listed = {}
    for element in ElementTree.fromstring(body).iter("Layer"):
        box = element.find("LatLonBoundingBox")
        if element.findtext("Name") is not None and box is not None:
            listed[element.findtext("Name")] = tuple(
                float(box.get(k)) for k in ("minx", "miny", "maxx", "maxy"))
    for name, (layer_view, _, _, _) in layers.items():
        want = tuple(float("%.9g" % v) for v in transform_extent(
            layer_view.geometry.bounds, layer_view.projection, "EPSG:4326"))
        check(listed.get(name) == want,
              "wms-serving: GetCapabilities lists %s as %s" % (name, listed.get(name)))
    foreign = view.to_json().replace("dask_geomodeling_tpu_torch.", "dask_geomodeling_tpu.")
    loaded = set(sys.modules)
    status, _, body, _ = client.get(getmap_params(foreign, style, vmin, vmax, tiles[0]))
    leaked = [m for m in set(sys.modules) - loaded if m.split(".")[0] in (
        "jax", "dask_geomodeling_tpu")]
    check(status == 400 and b"is outside" in body and not leaked,
          "wms-serving: a JAX-package layer answered %s %r (loaded %s)" % (status, body[:120], leaked))
    print("wms-serving: %d GetFeatureInfo answers equal the host's values (%d within the "
          "limits only); GetLegendGraphic of %s, GetCoverage of tile %s and GetCapabilities (%s "
          "with their WGS84 boxes) checked; a layer naming the JAX package's classes answered "
          "400 and loaded none of its modules"
          % (WMS_FEATURE_INFO - explained, explained, ", ".join(styles), tile,
             ", ".join(sorted(listed))))


def wms_threaded(layers, tiles):
    """WMS_THREADS threads call render_wms_tile on WMS_CONCURRENT_TILES
    distinct tiles (the last ones, half of each layer): each PNG equals
    the serial render, and the Gaussian launches once per ahn-smooth
    tile.  Returns (tiles, Gaussian launches)."""
    from concurrent.futures import ThreadPoolExecutor

    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import render_wms_tile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    jobs = [{k.lower(): v for k, v in getmap_params(name, style, vmin, vmax, tile).items()}
            for name, (_, style, vmin, vmax) in layers.items()
            for tile in tiles[-(WMS_CONCURRENT_TILES // len(layers)):]]
    serial = [render_wms_tile(p) for p in jobs]
    cuda_stencils.reset_launches()
    with ThreadPoolExecutor(max_workers=WMS_THREADS) as pool:
        threaded = list(pool.map(render_wms_tile, jobs))
    launched, moving_max = cuda_stencils.launches, cuda_stencils.moving_max_launches
    smooth_jobs = sum(1 for p in jobs if p["layers"] == "ahn-smooth")
    check(threaded == serial, "wms-serving: the threaded renders differ from the serial ones")
    check(launched == smooth_jobs and moving_max == 0, "wms-serving: %d Gaussian and %d "
          "moving-max launches from %d threaded ahn-smooth renders"
          % (launched, moving_max, smooth_jobs))
    print("wms-serving: %d threads rendered %d distinct tiles equal to the serial renders, %d "
          "Gaussian launches for %d ahn-smooth tiles" % (WMS_THREADS, len(jobs), launched,
                                                         smooth_jobs))
    return len(jobs), launched


def wms_tile_phases(view, request, device, seconds):
    """One GetMap tile's values, split into phases (synchronised) added
    to ``seconds``: the file window reads, the rest of the planning, the
    run on the card (its per-tile host staging included) and the copy to
    the host.  Returns (the answer, the Smooth input's plane shape or
    None, the clock at the end)."""
    import torch

    from dask_geomodeling_tpu_torch import compute_torch
    from dask_geomodeling_tpu_torch.io import geotiff

    read = geotiff.read_geotiff_window
    reads = [0.0]

    def timed_read(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return read(*args, **kwargs)
        finally:
            reads[0] += time.perf_counter() - t0

    def lap(phase, since):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - since
        return now

    t0 = time.perf_counter()
    geotiff.read_geotiff_window = timed_read
    try:
        graph, name = view.get_compute_graph(**request)
    finally:
        geotiff.read_geotiff_window = read
    t1 = lap("planning", t0)
    seconds["planning"] -= reads[0]
    seconds["file window reads"] = seconds.get("file window reads", 0.0) + reads[0]
    plane = None
    if getattr(graph[name][0], "__name__", "") == "_smooth_process":
        _kept.clear()
        compute_torch(dict(graph, kept=(_keep_on_device, graph[name][1])), "kept", device=device)
        plane = (1,) + tuple(_kept.pop()["values"].shape[-2:])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    _kept.clear()
    compute_torch(dict(graph, kept=(_keep_on_device, name)), "kept", device=device)
    data = _kept.pop()
    t2 = lap("device run", t1)
    data = dict(data, values=data["values"].cpu().numpy())
    return data, plane, lap("copy to the host", t2)


def wms_split(card, layers, tiles, picks, device, served):
    """The phases of the sampled tiles, read caches cleared first (an
    unmeasured pass): the planning's, the device's and the copy's
    (wms_tile_phases), the colour render and the PNG encode; each PNG is
    the one served.  Returns ({layer: mean ms a phase}, the Smooth plane)."""
    from dask_geomodeling_tpu_torch.io.png import write_png_bytes
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import tile_values
    from dask_geomodeling_tpu_torch.render import colormaps
    from dask_geomodeling_tpu_torch.runtime import pipeline

    pipeline.clear_read_cache()
    split, plane = {}, None
    for name, (view, style, vmin, vmax) in layers.items():
        seconds = {}
        for index in picks:
            data, tile_plane, t0 = wms_tile_phases(view, tile_request(tiles[index]), device, seconds)
            plane = tile_plane or plane  # the last zoom's
            normalized = colormaps.normalize(tile_values(data, WMS_TILE, WMS_TILE), vmin, vmax)
            rgba = colormaps.apply(style, normalized)
            rgba[np.ma.getmaskarray(normalized), 3] = 0
            t1 = time.perf_counter()
            seconds["render"] = seconds.get("render", 0.0) + t1 - t0
            png = write_png_bytes(rgba.transpose(2, 0, 1))
            seconds["PNG encode"] = seconds.get("PNG encode", 0.0) + time.perf_counter() - t1
            check(png == served[name][0][index], "wms-serving: the split %s tile %s differs from "
                  "the served one" % (name, tiles[index]))
        split[name] = {k: v / len(picks) * 1e3 for k, v in seconds.items()}
        print("wms-serving [%s] %s phases a tile (ms, mean of %d tiles, read caches cleared, "
              "synchronised): %s" % (card, name, len(picks),
                                     ", ".join("%s %.3f" % kv for kv in split[name].items())))
    return split, plane


def check_wms_serving(card, device, sheet, zooms=WMS_ZOOMS, sample=WMS_SAMPLE,
                      last_zoom_rows=WMS_LAST_ZOOM_ROWS):
    """The wms-serving phase: the port's WSGI server over two layers of
    the sheet (wms_layers), a slippy map's GetMap traffic (xyz_tiles) in
    four passes: cold (read caches cleared, no result cache), warm, fill
    (wms_serve's 256 MiB result cache) and hit; the host's ground truth on
    sampled tiles; GetFeatureInfo, GetLegendGraphic, GetCoverage,
    GetCapabilities and a JAX-package layer refused; a four-thread
    render; then, apart from the timed passes, a phase split and a warm
    pass under torch.profiler.  Returns ({kernel: launches of the cold
    pass, as counted}, the numbers)."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.geo import Extent
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import register_layer, unregister_layers
    from dask_geomodeling_tpu_torch.runtime import pipeline, results

    started = time.perf_counter()
    layers = wms_layers(sheet)
    smooth_view = layers["ahn-smooth"][0]
    bbox = Extent(smooth_view.geometry.bounds, "EPSG:28992").transformed("EPSG:3857").bbox
    every = len(xyz_tiles(bbox, zooms))
    tiles = xyz_tiles(bbox, zooms, last_zoom_rows)
    per_zoom = {z: sum(1 for t in tiles if t[0] == z) for z in zooms}
    print("wms-serving: %d of the %d XYZ tiles a layer over the sheet (%s; zoom %d cut to %s "
          "rows), %d layers, %d GetMaps a pass"
          % (len(tiles), every, ", ".join("zoom %d: %d" % kv for kv in per_zoom.items()),
             zooms[-1], last_zoom_rows, len(layers), len(tiles) * len(layers)))
    numbers = {"tiles_per_layer": len(tiles), "tiles_per_zoom": per_zoom}
    for name, (view, _, _, _) in layers.items():
        register_layer(name, view)
    client = WMSClient()
    try:
        with config.set({"geomodeling.block-import-paths": ["dask_geomodeling_tpu_torch"],
                         "geomodeling.wms-json-layers": True,
                         "geomodeling.result-cache-size": 0}):
            pipeline.clear_read_cache()
            cold, cold_launches = wms_pass(client, layers, tiles, "cold", card)
            warm, warm_launches = wms_pass(client, layers, tiles, "warm", card)
            results.clear()
            with config.set({"geomodeling.result-cache-size": WMS_CACHE_BYTES}):
                fill, fill_launches = wms_pass(client, layers, tiles, "fill", card)
                hit, hit_launches = wms_pass(client, layers, tiles, "hit", card)
            stats = results.stats()
            results.clear()
            passes = {"cold": cold_launches, "warm": warm_launches, "fill": fill_launches,
                      "hit": hit_launches}
            launches = {label: counts["gaussian_blur"] for label, counts in passes.items()}
            moving_max = {label: counts["moving_max"] for label, counts in passes.items()}
            print("wms-serving: Gaussian launches per pass %s for %d ahn-smooth tiles, moving-max "
                  "launches per pass %s; the result cache after the hit pass: %s"
                  % (json.dumps(launches), len(tiles), json.dumps(moving_max), stats))
            check(launches["cold"] == launches["warm"] == launches["fill"] == len(tiles),
                  "wms-serving: the cold, warm and fill passes launched %s Gaussians for %d tiles"
                  % (launches, len(tiles)))
            check(launches["hit"] == 0, "wms-serving: the hit pass launched %d Gaussians"
                  % launches["hit"])
            check(not any(moving_max.values()),
                  "wms-serving: a pass launched moving-max kernels: %s" % moving_max)
            check(stats["hits"] == len(tiles) * len(layers) and stats["evictions"] == 0,
                  "wms-serving: the hit pass was not served from the cache: %s" % stats)
            for name in layers:
                check(warm[name][0] == cold[name][0] and fill[name][0] == cold[name][0],
                      "wms-serving: %s: the warm or fill PNGs differ from the cold ones" % name)
                check(hit[name][0] == fill[name][0],
                      "wms-serving: %s: the hit PNGs differ from the fill ones" % name)
            numbers.update(
                passes={label: {name: p[name][1] for name in layers} for label, p in
                        (("cold", cold), ("warm", warm), ("fill", fill), ("hit", hit))},
                gaussian_launches=launches, moving_max_launches=moving_max, result_cache=stats)
            picks = np.linspace(0, len(tiles) - 1, sample).round().astype(int)
            numbers["in_process"] = wms_ground_truth(card, device, layers, tiles, picks, cold)
            wms_other_requests(client, device, layers, tiles, picks, os.path.dirname(sheet))
            numbers["threaded"] = wms_threaded(layers, tiles)
            numbers["phases_ms"], plane = wms_split(card, layers, tiles, picks, device, cold)
            # ahn-smooth's warm pass alone (both layers' took 14.3 s on an
            # NVIDIA H100 80GB HBM3 machine)
            profiled_s, busy_ms = device_busy_ms(lambda: wms_pass(
                client, {"ahn-smooth": layers["ahn-smooth"]}, tiles, "profiled warm", card))
    finally:
        client.close()
        unregister_layers()
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
    print("wms-serving [%s]: profiled warm pass %.4f s, device busy %s, idle share %s"
          % (card, profiled_s, "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
             "not measured" if idle is None else "%.4f" % idle))
    last = next(t for t in tiles if t[0] == zooms[-1])
    numbers.update(profiled_s=profiled_s, device_busy_ms=busy_ms, idle_share=idle,
                   plane=list(plane), sigma=list(smooth_sigma(smooth_view, tile_request(last))),
                   seconds=time.perf_counter() - started)
    return cold_launches, numbers


# --- the auto-routing phase ---

#: request edges (px) of the auto-routing phase, and requests a view and edge
AUTO_EDGES = (64, 128, 256, 512, 1024, 2048)
AUTO_PER_EDGE = 8


def auto_views(sheet, headline_view, headline_req):
    """{name: (view, request template, the limits' kind)}: the sheet's two
    WMS layers at the sheet's grid in EPSG:28992, and the headline view
    at its request's cell in EPSG:3857."""
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    layers = wms_layers(sheet)
    x1, y1, x2, y2 = RasterFileSource(sheet).geometry.bounds
    sheet_box = dict(mode="vals", projection="EPSG:28992", start=None,
                     bbox=(x1, y1, x2, y2), cell=SHEET_CELL)
    hx1, hy1, hx2, hy2 = headline_req["bbox"]
    head_box = dict(headline_req, cell=(hx2 - hx1) / headline_req["width"])
    del head_box["width"], head_box["height"]
    return {
        "ahn-smooth": (layers["ahn-smooth"][0], sheet_box, "bitwise"),
        "ahn-hillshade": (layers["ahn-hillshade"][0], sheet_box, "within-1"),
        "headline": (headline_view, head_box, "share"),
    }


def auto_requests(views, edges=AUTO_EDGES, per_edge=AUTO_PER_EDGE, seed=17):
    """[(view name, edge, request)]: ``per_edge`` requests a view and
    edge, each an edge^2 window at the view's cell, on the cell grid, at
    a position drawn from ``seed``, in one seeded, interleaved order."""
    rng = np.random.default_rng(seed)
    items = []
    for name, (_, template, _) in views.items():
        x1, y1, x2, y2 = template["bbox"]
        cell = template["cell"]
        cols, rows = int(round((x2 - x1) / cell)), int(round((y2 - y1) / cell))
        for edge in edges:
            for _ in range(per_edge):
                col = int(rng.integers(0, cols - edge + 1))
                row = int(rng.integers(0, rows - edge + 1))
                bbox = (x1 + col * cell, y2 - (row + edge) * cell,
                        x1 + (col + edge) * cell, y2 - row * cell)
                request = {k: v for k, v in template.items() if k != "cell"}
                request.update(bbox=bbox, width=edge, height=edge)
                items.append((name, edge, request))
    return [items[i] for i in rng.permutation(len(items))]


def routed_within_limits(kind, port, host, label):
    """(differing cells, cells) of a card-routed answer beside the host's
    (host_answer); raises where the limits of its path are broken:
    bitwise (the file-read view), within 1 (HillShade's float32
    transcendentals, the share held over all its answers by the caller),
    or only the share of differing cells (the headline's cross-CRS warp)."""
    a, e = port["values"], host["values"]
    check(a.shape == e.shape and a.dtype == e.dtype, "auto-routing: %s: shape or dtype differs"
          % label)
    differ, worst, _ = compare_cells(a, e, host["no_data_value"])
    if kind == "bitwise":
        check(differ == 0, "auto-routing: a card-routed %s answer differs from compute_host "
              "in %d cells" % (label, differ))
    elif kind == "within-1":
        check(worst <= 1, "auto-routing: a card-routed %s answer is %r off" % (label, worst))
    return differ, e.size


def host_answer(view, request, tile=TILE):
    """compute_host of ``request`` as the card's route runs it: whole up
    to one tile, else tile by tile (tile_requests), assembled as
    evaluate_tiled assembles the card's tiles; a Smooth's values near a
    tile border depend on the tile grid (the Gaussian reaches past its
    margin), so a tiled answer is held to its own tiles."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    width, height = request["width"], request["height"]
    if max(width, height) <= tile:
        return compute_host(*view.get_compute_graph(**request))
    tiles, nx = tile_requests(request, tile)
    out = None
    for index, tile_request in enumerate(tiles):
        host = compute_host(*view.get_compute_graph(**tile_request))
        if out is None:
            out = np.empty((host["values"].shape[0], height, width), host["values"].dtype)
        (rows, cols), (tile_rows, tile_cols) = tile_cells(index, nx, width, height, tile)
        out[:, rows, cols] = host["values"][:, tile_rows, tile_cols]
    return {"values": out, "no_data_value": host["no_data_value"]}


def check_auto_routing(card, device, folder, sheet, headline_view, headline_req,
                       edges=AUTO_EDGES, per_edge=AUTO_PER_EDGE):
    """The auto-routing phase: geomodeling.executor "auto" over three views
    (auto_views) and ``per_edge`` requests of each edge (auto_requests:
    144 at the defaults), the router
    exploring from an empty table whose state file lives in ``folder``;
    every route taken, the Gaussian launches per route, the first
    card-routed answer of each view and edge against compute_host (every
    one until the host's 19 s of it had to fit the script into 700 s);
    the table's final rates and settled
    routes per view and edge; after save and a reseeded reset, one
    request per key takes its settled route; status.snapshot(), and a
    request of the largest edge under the Profiler and torch_trace.  Returns
    ({kernel: launches in the routed requests}, the numbers)."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import pipeline, router, status
    from dask_geomodeling_tpu_torch.runtime.profile import Profiler, torch_trace

    started = time.perf_counter()
    views = auto_views(sheet, headline_view, headline_req)
    items = auto_requests(views, edges, per_edge)
    state = os.path.join(folder, "router-state.json")
    routes = []
    real_choose = router.choose

    def choosing(view, request, eligible):
        routes.append(real_choose(view, request, eligible))
        return routes[-1]

    settings = {"geomodeling.executor": "auto", "geomodeling.router-state": state,
                "geomodeling.auto-min-device-px": 0, "geomodeling.result-cache-size": 0,
                "geomodeling.torch-device": str(device)}
    table = {}
    share = {name: [0, 0] for name in views}
    launches = {"gaussian_blur": 0, "moving_max": 0}
    host_s = 0.0
    router.choose = choosing
    try:
        with config.set(settings):
            router.reset(reseed=False)
            pipeline.clear_read_cache()
            for name, edge, request in items:
                view, _, kind = views[name]
                cuda_stencils.reset_launches()
                t0 = time.perf_counter()
                out = view.get_data(**request)
                seconds = time.perf_counter() - t0
                route = routes[-1]
                entry = table.setdefault((name, edge), {"numpy": 0, "torch": 0, "gaussian": {
                    "numpy": 0, "torch": 0}, "seconds": {"numpy": [], "torch": []}})
                entry[route] += 1
                entry["gaussian"][route] += cuda_stencils.launches
                entry["seconds"][route].append(seconds)
                launches["gaussian_blur"] += cuda_stencils.launches
                launches["moving_max"] += cuda_stencils.moving_max_launches
                if route == "torch" and entry["torch"] == 1:
                    t0 = time.perf_counter()
                    host = host_answer(view, request, config.get("geomodeling.tile-size"))
                    host_s += time.perf_counter() - t0
                    differ, cells = routed_within_limits(kind, out, host, "%s %d^2" % (name, edge))
                    share[name][0] += differ
                    share[name][1] += cells
            keys = {}
            for (name, edge), entry in sorted(table.items(), key=lambda kv: (kv[0][0], kv[0][1])):
                view = views[name][0]
                request = next(r for n, e, r in items if n == name and e == edge)
                # the route the router takes next for this key
                settled = router.route_of(view, request)
                s = router.state_of(view, request)
                keys[(name, edge)] = settled
                entry.update(host_mpx_s=s["numpy"], card_mpx_s=s["torch"], settled=settled,
                             torch_runs=s["torch_runs"])
                print("auto-routing [%s] %s %d^2: routes numpy %d, torch %d; Gaussian launches "
                      "on host routes %d, on card routes %d; final host %s Mpx/s, card %s Mpx/s; "
                      "settled %s" % (card, name, edge, entry["numpy"], entry["torch"],
                                      entry["gaussian"]["numpy"], entry["gaussian"]["torch"],
                                      s["numpy"], s["torch"], settled))
            for (name, edge), entry in table.items():
                check(entry["gaussian"]["numpy"] == 0, "auto-routing: %s %d^2: host routes "
                      "launched %d Gaussians" % (name, edge, entry["gaussian"]["numpy"]))
                if name == "ahn-smooth" and entry["torch"]:
                    check(entry["gaussian"]["torch"] >= entry["torch"], "auto-routing: %s %d^2: "
                          "%d card routes launched %d Gaussians" % (
                              name, edge, entry["torch"], entry["gaussian"]["torch"]))
            taken = {r: routes.count(r) for r in ("numpy", "torch")}
            check(taken["numpy"] > 0 and taken["torch"] > 0,
                  "auto-routing: only one route was taken: %s" % taken)
            for name, (differ, cells) in share.items():
                limit = {"ahn-smooth": 0.0, "ahn-hillshade": STENCILS_SHARE,
                         "headline": HEADLINE_SHARE}[name]
                check(differ <= limit * cells, "auto-routing: %s: %d of %d card-routed cells "
                      "differ from compute_host" % (name, differ, cells))
                print("auto-routing: %s: %d of %d card-routed cells differ from compute_host "
                      "(limit share %r)" % (name, differ, cells, limit))
            # the settled routes survive a save and a reseeded reset
            router.save()
            router.reset(reseed=True)
            del routes[:]
            for (name, edge), settled in keys.items():
                request = next(r for n, e, r in items if n == name and e == edge)
                views[name][0].get_data(**request)
                check(routes[-1] == settled, "auto-routing: %s %d^2 took %s after the reseed, "
                      "settled %s" % (name, edge, routes[-1], settled))
            print("auto-routing: after save and reset(reseed=True) from %s, one request per key "
                  "took its settled route (%d keys, %d to the card)"
                  % (os.path.basename(state), len(keys), sum(v == "torch" for v in keys.values())))
            snapshot = status.snapshot()
            print("auto-routing: status.snapshot() %s" % json.dumps(snapshot))
            # one request of the largest edge of the file-read view under the
            # Profiler and torch_trace
            name, edge, request = next(i for i in items
                                       if i[0] == "ahn-smooth" and i[1] == max(edges))
            trace_dir = os.path.join(folder, "trace")
            with config.set({"geomodeling.executor": "torch"}):
                with torch_trace(trace_dir), Profiler() as prof:
                    views[name][0].get_data(**request)
            trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
            check(trace_bytes > 0, "auto-routing: torch_trace wrote an empty trace")
            print("auto-routing: Profiler summary of one %s %d^2 request on the card (torch_trace "
                  "wrote %d bytes):\n%s" % (name, edge, trace_bytes, prof.summary()))
    finally:
        router.choose = real_choose
        with config.set({"geomodeling.router-state": None}):
            router.reset(reseed=False)  # nothing left for the exit's autosave
    # per view, the smallest edge from which the card settles at every
    # larger edge (None: the host at the largest)
    crossover = {name: next((e for e in edges if all(
        keys[(name, f)] == "torch" for f in edges if f >= e)), None) for name in views}
    print("auto-routing [%s]: %d requests, routes taken %s, the smallest edge from which the card "
          "settles at every larger edge: %s; host ground truth %.3f s; the phase %.1f s"
          % (card, len(items), json.dumps(taken), json.dumps(crossover), host_s,
             time.perf_counter() - started))
    numbers = dict(
        requests=len(items), routes=taken, crossover_edge=crossover, host_s=host_s,
        table={"%s %d" % key: {k: v for k, v in entry.items() if k != "seconds"}
               for key, entry in table.items()},
        snapshot=snapshot, trace_bytes=trace_bytes, seconds=time.perf_counter() - started)
    return launches, numbers


# --- the building-rings phase ---

#: the building-rings path: the building-heights footprints inside a
#: RINGS_SIDE^2 sub-area of the sheet (about 400 of them; 1400 m and
#: 1209 footprints took 48.6 s of the phase, and building-formats' round
#: over the same square 56.66 s of compute_host), buffered by
#: RINGS_DISTANCE m, minus the footprint, simplified at RINGS_SIMPLIFY m
RINGS_SIDE = 800.0
#: the rings' export tiles: a quarter of the square, so that rings are
#: clipped across tile borders as over 1400 m in 1000 m tiles
RINGS_TILE = 400.0
RINGS_DISTANCE = 10.0
RINGS_SIMPLIFY = 0.25
RINGS_SUB = 300.0
RINGS_FIELDS = ("identificatie", "bouwjaar", "ring_mean", "ring_p10", "h_mean", "peil",
                "kelder", "drempel")
#: the fields that may differ from the host's where an unrounded mean is
#: one float32 ulp off (float64 atomics): the rounded means, and the
#: floor level above the ring's
RINGS_ROUNDED = ("ring_mean", "h_mean", "drempel")


def rings_area(bbox, side=RINGS_SIDE):
    """The rings' sub-area: a side^2 box in the middle of ``bbox``."""
    cx, cy = (bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2
    half = min(side, bbox[2] - bbox[0], bbox[3] - bbox[1]) / 2
    return (cx - half, cy - half, cx + half, cy + half)


def description(rng):
    """A ``beschrijving``: key=value lines as a water board's building
    register carries them, a floor level (vloerpeil, m NAP) missing in one
    of ten and null in one of twenty, a basement flag and a source."""
    lines = ["bron=BAG"]
    draw = rng.random()
    if draw >= 0.15:
        lines.append("vloerpeil=%.2f" % rng.uniform(2.0, 9.0))
    elif draw >= 0.10:
        lines.append("vloerpeil=null")
    lines.append("kelder=%s" % ("true" if rng.random() < 0.2 else "false"))
    lines.append("opmerking=peil ingemeten %d" % rng.integers(1995, 2024))
    return "\n".join(lines)


def write_rings_buildings(folder, sheet_bbox, area, count=BUILDINGS, seed=13):
    """Write the footprints of write_buildings(sheet_bbox, count, seed)
    whose every vertex lies inside ``area`` into ``folder``/rings.gpkg,
    layer "pand", with a ``beschrijving`` of key=value lines (seeded);
    returns (its path, the number written)."""
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    frame = square_frame(sheet_bbox, area, count, seed)
    rng = np.random.default_rng(seed + 1)
    frame["beschrijving"] = [description(rng) for _ in range(len(frame))]
    path = os.path.join(folder, "rings.gpkg")
    write_vector(frame, path, layer="pand")
    return path, len(frame)


def rings_blocks(buildings, sheet):
    """The building-rings view's blocks: {"view", "ring_mean", "own_mean"}
    (the two unrounded means' AggregateRaster blocks).  The view: a 10 m
    ring around each footprint (Buffer, Difference with the footprint,
    Simplify), the mean and 10th percentile of the smoothed sheet over
    the ring, merged (left) with the footprint's own mean height, the
    floor level and basement flag parsed from the description, the floor
    level above the ring's mean ground, and each ring clipped to the
    request's geometry (Intersection)."""
    from dask_geomodeling_tpu_torch.geometry import (
        AggregateRaster,
        Buffer,
        Difference,
        GeometryFileSource,
        Intersection,
        MergeGeometryBlocks,
        ParseTextColumn,
        Round,
        Simplify,
    )
    from dask_geomodeling_tpu_torch.raster import RasterFileSource, Smooth

    footprints = GeometryFileSource(buildings, layer="pand")
    rings = Simplify(Difference(Buffer(footprints, RINGS_DISTANCE, "EPSG:28992"), footprints),
                     RINGS_SIMPLIFY)
    dem = Smooth(RasterFileSource(sheet), 3)
    ring_mean = AggregateRaster(rings, dem, "mean")
    own_mean = AggregateRaster(footprints, dem, "mean")
    stats = rings.set("ring_mean", Round(ring_mean["agg"], 2),
                      "ring_p10", AggregateRaster(rings, dem, "p10")["agg"])
    own = footprints.set("h_mean", Round(own_mean["agg"], 2))
    merged = MergeGeometryBlocks(stats, own, how="left")
    parsed = ParseTextColumn(merged, "beschrijving", {"vloerpeil": "peil", "kelder": "kelder"})
    view = Intersection(parsed.set("drempel", parsed["peil"] - parsed["ring_mean"]))
    return {"view": view, "ring_mean": ring_mean, "own_mean": own_mean}


def build_rings_view(buildings, sheet):
    """The building-rings view (rings_blocks)."""
    return rings_blocks(buildings, sheet)["view"]


def rings_clock():
    """A PhaseClock over the building-rings export: the buffers (the
    distance fields and their contours), the differences, the vector
    file reads, the zonal statistics' device plane and the sinks' writes
    and merge."""
    from dask_geomodeling_tpu_torch.geo import _buffer
    from dask_geomodeling_tpu_torch.geo.features import GeoSeries
    from dask_geomodeling_tpu_torch.geometry import aggregate
    from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.runtime import pipeline

    return PhaseClock([
        (_buffer, "buffer", "buffer"),
        (GeoSeries, "difference", "difference"),
        (pipeline, "read_vector_cached", "vector read"),
        (vectorfile, "_read_gpkg", "vector read"),
        (aggregate, "_aggregate_on_device", "zonal"),
        (GeometryFileSink, "process", "sink"),
        (GeometryFileSink, "merge_files", "sink"),
    ])


def check_building_rings(card, device, folder, sheet, side=RINGS_SIDE, tile=RINGS_TILE,
                         sub_size=RINGS_SUB, count=BUILDINGS):
    """The building-rings phase: the rings view (build_rings_view) over
    the footprints inside a side^2 sub-area of the sheet, exported by
    to_file in tiles of ``tile`` m (GeometryTiler over GeometryFileSink
    GeoPackages, merged) under the phase clock; one tile against
    compute_host; a sub_size^2 sub-area exported untiled as GeoJSON
    byte-identical to the host's export.  Returns ({kernel: launches of
    the export}, the numbers)."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSink, GeometryTiler
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    started = time.perf_counter()
    sheet_bbox = RasterFileSource(sheet).geometry.bounds
    area = rings_area(sheet_bbox, side)
    t0 = time.perf_counter()
    buildings, count = write_rings_buildings(folder, sheet_bbox, area, count)
    write_s = time.perf_counter() - t0
    print("building-rings: %d of the building-heights footprints inside a %g m square "
          "(%.3f km^2) written with a beschrijving to a GeoPackage in %.2f s"
          % (count, area[2] - area[0], (area[2] - area[0]) * (area[3] - area[1]) / 1e6, write_s))
    blocks = rings_blocks(buildings, sheet)
    view = blocks["view"]
    fields = {name: name for name in RINGS_FIELDS}
    projection = "EPSG:28992"
    pipeline.clear_read_cache()
    target = os.path.join(folder, "rings_export.gpkg")
    # the request names its geometry: an Intersection answers no extent
    # request without one (in the JAX package too), and to_file asks for
    # the extent when the request has none
    export_request = dict(mode="centroid", geometry=box(*area), projection=projection)
    cuda_stencils.reset_launches()
    with rings_clock() as clock:
        t0 = time.perf_counter()
        to_file(view, target, fields=fields, tile_size=tile, device=device, **export_request)
        export_s = time.perf_counter() - t0
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    pieces = GeometryTiler(view, tile, projection).get_sources_and_requests(**export_request)
    subrequests = [request for _, request in pieces]
    merged = vectorfile.read_vector(target)
    phases = dict(clock.seconds)
    phases["other"] = export_s - sum(phases.values())
    print("building-rings: to_file of %d buildings in %d tiles of %g m: %.3f s, %.1f "
          "buildings/s, %d rings in the merged file [%s]" % (
              count, len(subrequests), tile, export_s, count / export_s, len(merged), card))
    print("building-rings: phases (s; the buffers and the differences run on the host, the "
          "zonal statistics' device plane on the card; %d timed calls): %s" % (
              sum(clock.calls.values()), json.dumps({k: round(v, 4) for k, v in phases.items()})))
    print("building-rings: %d Gaussian launches (two a tile: the rings' and the footprints' "
          "AggregateRaster read the sheet over different boxes), %d moving-max launches"
          % (launches["gaussian_blur"], launches["moving_max"]))
    check(launches["gaussian_blur"] == 2 * len(subrequests),
          "building-rings: %d Gaussian launches for %d tiles" % (launches["gaussian_blur"],
                                                                 len(subrequests)))
    check(set(merged.columns) == set(RINGS_FIELDS) | {"geometry"},
          "building-rings: the fields are %s" % sorted(merged.columns))
    check(len(merged) == count, "building-rings: %d rings exported for %d buildings"
          % (len(merged), count))
    check(all(g is not None and not g.is_empty and g.area > 0 for g in merged.geometry.values),
          "building-rings: an empty ring was exported")
    peil = merged["peil"].values.astype(float)
    print("building-rings: %d rings; floor level parsed in %d, missing or null in %d; "
          "kelder %s; ring areas %.1f-%.1f m^2" % (
              len(merged), np.isfinite(peil).sum(), (~np.isfinite(peil)).sum(),
              sorted(set(merged["kelder"].tolist()), key=repr),
              min(g.area for g in merged.geometry.values),
              max(g.area for g in merged.geometry.values)))

    mean_views = [blocks["ring_mean"], blocks["own_mean"]]

    # one tile against compute_host: the host's partial file of the same
    # subrequest against the export's rows of those fids
    host_s = 0.0
    merged_rows = frame_rows(merged)
    host_dir = os.path.join(folder, "rings_host")
    # the tile with the fewest rings (the host's buffers cost tens of ms each)
    request = min((r for r in subrequests if any(r["geometry"].intersects(g.centroid)
                                                 for g in merged.geometry.values)),
                  key=lambda r: sum(r["geometry"].intersects(g.centroid)
                                    for g in merged.geometry.values))
    sink = GeometryFileSink(view, host_dir, extension="gpkg", fields=fields)
    t0 = time.perf_counter()
    compute_host(*sink.get_compute_graph(**request))
    host_s += time.perf_counter() - t0
    host_rows = frame_rows(vectorfile.read_vector(
        os.path.join(host_dir, tokenize(request)[:7] + ".gpkg")))
    check(len(host_rows) > 0, "building-rings: the host's tile is empty")
    differing = compare_heights("building-rings tile", {fid: merged_rows[fid] for fid in host_rows
                                                        if fid in merged_rows}, host_rows,
                                mean_ulps(mean_views, request, device), RINGS_ROUNDED)
    print("building-rings: one tile's %d rows equal compute_host of its subrequest (%.3f s on the "
          "host): geometry, ring_p10, peil and kelder bitwise, the rounded means differing in "
          "%d rows [%s]" % (len(host_rows), host_s, len(differing), card))

    # a sub-area exported untiled as GeoJSON, against the host's export
    x1, y1, x2, y2 = area
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    sub = box(cx - sub_size / 2, cy - sub_size / 2, cx + sub_size / 2, cy + sub_size / 2)
    sub_request = dict(mode="centroid", geometry=sub, projection=projection)
    ours = os.path.join(folder, "rings_sub.geojson")
    to_file(view, ours, fields=fields, device=device, **sub_request)
    host_target = os.path.join(folder, "rings_host_sub.geojson")
    sink_dir = os.path.join(folder, "rings_host_sub")
    t0 = time.perf_counter()
    compute_host(*GeometryFileSink(view, sink_dir, extension="geojson", fields=fields)
                 .get_compute_graph(**sub_request))
    GeometryFileSink.merge_files(sink_dir, host_target)
    host_s += time.perf_counter() - t0
    port_rows = frame_rows(vectorfile.read_vector(ours))
    differ = compare_heights("building-rings sub-area", port_rows,
                             frame_rows(vectorfile.read_vector(host_target)),
                             mean_ulps(mean_views, sub_request, device), RINGS_ROUNDED)
    identical = geojson_equal(ours, host_target, [], RINGS_ROUNDED)
    check(geojson_equal(ours, host_target, differ, RINGS_ROUNDED),
          "building-rings: the GeoJSON differs from the host's beyond the rounded means of "
          "%d rows" % len(differ))
    check(len(port_rows) > 5, "building-rings: the sub-area holds %d rings" % len(port_rows))
    print("building-rings: a %g m sub-area exported untiled as GeoJSON: %d rings clipped to it, "
          "byte-identical to the host's export: %s (rounded means differing in %d rows)"
          % (sub_size, len(port_rows), identical, len(differ)))
    total_s = time.perf_counter() - started
    print("building-rings: host ground truth %.3f s; the phase %.1f s [%s]"
          % (host_s, total_s, card))
    return launches, dict(
        buildings=count, area_km2=(area[2] - area[0]) * (area[3] - area[1]) / 1e6,
        tiles=len(subrequests), export_s=export_s, buildings_per_s=count / export_s,
        phases=phases, host_s=host_s, phase_s=total_s, rows_differing=len(differing) + len(differ),
        geojson_identical=identical, write_s=write_s)


# --- the building-formats phase ---

#: the formats of the building-formats round over the rings' square:
#: (format, file name, layer read, CRS written; None: no CRS, the
#: request's).  SpatiaLite, the zipped shapefile and DXF keep RD
#: coordinates exactly; the others go through degrees.
FORMAT_ROUND = (
    ("sqlite", "pand.sqlite", "pand", "EPSG:28992"),
    ("zip", "pand.zip", "pand", "EPSG:28992"),
    ("dxf", "pand.dxf", None, None),
    ("mif", "pand.mif", None, "EPSG:4326"),
    ("topojson", "pand.topojson", "pand", "EPSG:4326"),
    ("kml", "pand.kml", None, "EPSG:4326"),
    ("kmz", "pand.kmz", None, "EPSG:4326"),
    ("osm", "pand.osm", "multipolygons", "EPSG:4326"),
    ("gpx", "pand.gpx", "tracks", "EPSG:4326"),
)
#: the buffer around a GPX track (a footprint's outer ring), at two points
#: a quarter circle: the distance field's cell is then the sheet's 0.5 m,
#: and the host's buffer of a track takes milliseconds, not a tenth of a
#: second
GPX_BUFFER = 1.0
GPX_BUFFER_RESOLUTION = 2
#: the computed fields of build_buildings_view, compared across formats
HEIGHT_FIELDS = ("h_mean", "h_p90", "relief", "area", "geometry")


def square_frame(sheet_bbox, area, count=BUILDINGS, seed=13):
    """building_frame(sheet_bbox, count, seed) cut to the footprints whose
    every vertex lies inside ``area``."""
    frame = building_frame(sheet_bbox, count, seed)
    x1, y1, x2, y2 = area
    keep = np.array([x1 < g.bounds[0] and g.bounds[2] < x2 and y1 < g.bounds[1]
                     and g.bounds[3] < y2 for g in frame.geometry.values])
    return frame.iloc[np.flatnonzero(keep)]


def write_osm(frame, path):
    """OSM XML of a frame of polygons in EPSG:4326 (neither package writes
    OSM): a node per vertex, a closed way per footprint tagged
    building=yes, its id the frame's index label."""
    lines = ['<?xml version="1.0" encoding="UTF-8"?>', '<osm version="0.6" generator="chip_smoke">']
    ways = []
    node = 0
    for fid, geom in zip(frame.index.values.tolist(), frame.geometry.values):
        refs = []
        for lon, lat in list(geom.exterior.coords)[:-1]:
            node += 1
            lines.append('  <node id="%d" lat="%r" lon="%r"/>' % (node, float(lat), float(lon)))
            refs.append(node)
        ways.append('  <way id="%d">%s<tag k="building" v="yes"/></way>' % (
            fid, "".join('<nd ref="%d"/>' % r for r in refs + refs[:1])))
    with open(path, "w") as f:
        f.write("\n".join(lines + ways + ["</osm>"]) + "\n")


def write_format(fmt, frame, path, crs):
    """Write the square's footprints as ``fmt`` (in ``crs``): GPX as the
    outer rings, tracks named after the fid; OSM by write_osm."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import LineString
    from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

    if crs is not None and crs != frame.crs:
        frame = frame.to_crs(crs)
    if fmt == "osm":
        return write_osm(frame, path)
    if fmt == "gpx":
        frame = GeoDataFrame({"name": [str(fid) for fid in frame.index.values.tolist()]},
                             geometry=[LineString(list(g.exterior.coords))
                                       for g in frame.geometry.values], crs=crs)
    write_vector(frame, path, layer="pand")


def format_fids(fmt, features, written):
    """The building fid of each row a format's view answered: SpatiaLite
    and TopoJSON keep the index, KML and KMZ their Placemark ids, OSM
    its way ids, GPX its track names, MIF the identificatie, the
    shapefile (whose field names stop at 10 characters) and DXF only the
    order of the rows written."""
    labels = features.index.values.tolist()
    if fmt in ("sqlite", "topojson", "kml", "kmz"):
        return [int(label) for label in labels]
    if fmt == "osm":
        return [int(v) for v in features["osm_id"].values.tolist()]
    if fmt == "gpx":
        return [int(v) for v in features["name"].values.tolist()]
    if fmt in ("dxf", "zip"):
        return [written[label] for label in labels]
    return [int(v) % 10**6 for v in features["identificatie"].values.tolist()]


def height_rows(features, fids, fields=HEIGHT_FIELDS):
    """{fid: {field: cell}} of a view's answer, the geometry as WKB."""
    rows = frame_rows(features)
    return {fid: {k: rows[label][k] for k in fields}
            for fid, label in zip(fids, features.index.values.tolist())}


def building_fid(identificatie):
    """The fid of an identificatie, as text or as the int a GML read
    sniffs it to."""
    return int(identificatie) % 10**6


def check_building_formats(card, device, folder, sheet, side=RINGS_SIDE, tile=BUILDING_TILE,
                           count=BUILDINGS, formats=FORMAT_ROUND):
    """The building-formats phase.  (a) The 20,000 footprints written as
    GML (layer pand, srsName EPSG:28992, as BGT and BAG extracts arrive),
    read by GeometryFileSource into build_buildings_view and exported by
    to_file in ``tile`` m tiles into GML partials merged into one GML over
    a block of 3 x 3 of the tiles (export_block): every row equal to
    building-heights' GeoPackage export (``heights.gpkg`` in ``folder``),
    one tile to compute_host.  (b) The
    footprints of the rings' side^2 square in each format of ``formats``,
    read back through GeometryFileSource (GPX's tracks through a 1 m
    Buffer) and asked once for the whole square on the card: the formats
    that keep RD coordinates equal to the GML view's answer row for row,
    the others (a round trip through degrees moves vertices in their last
    bits) to compute_host of their view.  Returns ({kernel:
    launches of the path}, the numbers)."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch.core.tokens import tokenize
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry import GeometryFileSink
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.io import vectorfile
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource
    from dask_geomodeling_tpu_torch.runtime import pipeline

    started = time.perf_counter()
    projection = "EPSG:28992"
    sheet_bbox = RasterFileSource(sheet).geometry.bounds
    frame = building_frame(sheet_bbox, count)
    gml = os.path.join(folder, "buildings.gml")
    t0 = time.perf_counter()
    vectorfile.write_vector(frame, gml, layer="pand")
    write_s = time.perf_counter() - t0
    pipeline.clear_read_cache()
    t0 = time.perf_counter()
    read = vectorfile.read_vector(gml, layer="pand")
    read_s = time.perf_counter() - t0
    check(len(read) == count and read.crs == projection, "building-formats: the GML read back "
          "%d footprints in %s" % (len(read), read.crs))
    print("building-formats: %d footprints written to GML (layer pand, srsName %s) in %.2f s, "
          "%d bytes; read back in %.2f s" % (count, projection, write_s, os.path.getsize(gml),
                                            read_s))
    del read
    pipeline.clear_read_cache()
    view = build_buildings_view(gml, sheet)
    source = view.args[0]
    mean_view = view.args[2].args[0].source

    # (a) the tiled export into GML partials, merged into one GML, over a
    # block of 3 x 3 of the export's tiles, each tile the same square as
    # the whole export's
    target = os.path.join(folder, "heights.gml")
    extent = source.get_data(mode="extent", projection=projection)["extent"]
    centroids = np.array([g.centroid.coords[0] for g in frame.geometry.values])
    block, pieces, in_block = export_block(source, extent, tile, projection, centroids)
    cuda_stencils.reset_launches()
    with export_clock() as clock:
        t0 = time.perf_counter()
        to_file(view, target, tile_size=tile, projection=projection, mode="centroid",
                device=device, geometry=block)
        export_s = time.perf_counter() - t0
    launches = {"gaussian_blur": cuda_stencils.launches,
                "moving_max": cuda_stencils.moving_max_launches}
    subrequests = [request for _, request in pieces]
    exported = int(in_block.sum())
    phases = dict(clock.seconds)
    phases["planning"] = export_s - phases["run"] - phases["merge"]
    merged = vectorfile.read_vector(target)
    check(len(merged) == exported, "building-formats: the merged GML holds %d buildings, the "
          "block %d" % (len(merged), exported))
    print("building-formats: to_file of the %d buildings of a block of %d of the tiles of %g m "
          "from the GML into GML partials, merged: %.3f s, %.1f buildings/s, %d in the merged "
          "GML [%s]" % (exported, len(subrequests), tile, export_s, exported / export_s,
                        len(merged), card))
    print("building-formats: phases (s; the vector read parses the GML once, the merge parses "
          "the %d partials; %d timed calls): %s" % (
              len(subrequests), sum(clock.calls.values()),
              json.dumps({k: round(v, 4) for k, v in phases.items()})))
    print("building-formats: %d Gaussian launches in the GML export (one per tile), %d "
          "moving-max launches" % (launches["gaussian_blur"], launches["moving_max"]))
    check(launches["gaussian_blur"] == len(subrequests) > 0,
          "building-formats: %d Gaussian launches for %d tiles"
          % (launches["gaussian_blur"], len(subrequests)))

    def by_fid(frame_read):
        rows = {}
        for row in frame_rows(frame_read).values():
            row["identificatie"] = "%016d" % int(row["identificatie"])
            rows[building_fid(row["identificatie"])] = row
        return rows

    def tile_ulps(requests):
        """mean_ulps over the tiles: each fid on the tile its centroid
        lies in (the GML source's labels are pand.<fid - 1>)."""
        def ulps(fids):
            out = []
            for request in requests:
                x1, y1, x2, y2 = request["geometry"].bounds
                here = []
                for fid in fids:
                    cx, cy = frame.geometry.values[fid - 1].centroid.coords[0]
                    if x1 < cx < x2 and y1 < cy < y2:
                        here.append("pand.%d" % (fid - 1))
                if here:
                    out += mean_ulps([mean_view], request, device)(here)
            return out
        return ulps

    gml_rows = by_fid(merged)
    gpkg_rows = by_fid(vectorfile.read_vector(os.path.join(folder, "heights.gpkg")))
    block_fids = {int(fid) for fid in frame.index.values[in_block]}
    check(set(gml_rows) == block_fids, "building-formats: the GML export holds other buildings "
          "than those of its block")
    gpkg_rows = {fid: row for fid, row in gpkg_rows.items() if fid in block_fids}
    differing = compare_heights("building-formats GML export", gml_rows, gpkg_rows,
                                tile_ulps(subrequests))
    print("building-formats: the merged GML's %d rows equal building-heights' GeoPackage "
          "export: every field bitwise, h_mean differing in %d rows (within one float32 ulp "
          "before rounding)" % (len(gml_rows), len(differing)))
    host_dir = os.path.join(folder, "formats_host")
    request = subrequests[len(subrequests) // 3]
    t0 = time.perf_counter()
    compute_host(*GeometryFileSink(view, host_dir, extension="gml").get_compute_graph(**request))
    host_s = time.perf_counter() - t0
    host_rows = by_fid(vectorfile.read_vector(
        os.path.join(host_dir, tokenize(request)[:7] + ".gml")))
    tile_differ = compare_heights("building-formats GML tile",
                                  {fid: gml_rows[fid] for fid in host_rows}, host_rows,
                                  tile_ulps([request]))
    print("building-formats: one tile's %d rows equal compute_host of its subrequest (%.3f s "
          "on the host), h_mean differing in %d rows [%s]"
          % (len(host_rows), host_s, len(tile_differ), card))

    # (b) a round of the other formats over the rings' square
    area = rings_area(sheet_bbox, side)
    square = square_frame(sheet_bbox, area, count)
    request = dict(mode="centroid", geometry=box(*area), projection=projection)
    pipeline.clear_read_cache()
    reference = view.get_data(device=device, **request)["features"]
    reference_rows = height_rows(reference, [building_fid(v) for v in
                                             reference["identificatie"].values.tolist()])
    check(set(square.index.values.tolist()) <= set(reference_rows), "building-formats: the GML "
          "view does not answer every footprint of the square")
    round_launches = {"gaussian_blur": 0, "moving_max": 0}
    numbers = {}
    for fmt, name, layer, crs in formats:
        path = os.path.join(folder, name)
        t0 = time.perf_counter()
        write_format(fmt, square, path, crs)
        fmt_write_s = time.perf_counter() - t0
        pipeline.clear_read_cache()
        t0 = time.perf_counter()
        rows_read = len(pipeline.read_vector_cached(path, layer))
        fmt_read_s = time.perf_counter() - t0
        fmt_view = build_buildings_view(path, sheet, layer=layer,
                                        buffer=GPX_BUFFER if fmt == "gpx" else None)
        fmt_mean = fmt_view.args[2].args[0].source
        cuda_stencils.reset_launches()
        t0 = time.perf_counter()
        features = fmt_view.get_data(device=device, **request)["features"]
        card_s = time.perf_counter() - t0
        round_launches["gaussian_blur"] += cuda_stencils.launches
        round_launches["moving_max"] += cuda_stencils.moving_max_launches
        check(cuda_stencils.launches == 1, "building-formats %s: %d Gaussian launches"
              % (fmt, cuda_stencils.launches))
        check(len(features) == len(square), "building-formats %s: %d rows for the square's %d "
              "footprints" % (fmt, len(features), len(square)))
        ulps = mean_ulps([fmt_mean], request, device)
        if crs in (projection, None):
            # RD kept exactly: held to the GML view's answers, not to
            # compute_host (a shapefile turns its outer rings clockwise:
            # the geometry's WKB and the area's last bits differ, the
            # height fields do not)
            fields = HEIGHT_FIELDS if fmt != "zip" else ("h_mean", "h_p90", "relief")
            labels = features.index.values.tolist()
            fids = dict(zip(labels, format_fids(fmt, features, square.index.values.tolist())))
            differ = compare_heights(
                "building-formats %s against the GML view" % fmt,
                height_rows(features, labels, fields),
                {label: {k: reference_rows[fids[label]][k] for k in fields} for label in labels},
                ulps)
            against, fmt_host_s = "the GML view's %s" % "/".join(fields), None
        else:
            t0 = time.perf_counter()
            host = compute_host(*fmt_view.get_compute_graph(**request))["features"]
            fmt_host_s = time.perf_counter() - t0
            differ = compare_heights("building-formats " + fmt, frame_rows(features),
                                     frame_rows(host), ulps)
            against = "compute_host"
        numbers[fmt] = dict(rows=len(features), rows_read=rows_read, write_s=fmt_write_s,
                            read_s=fmt_read_s, card_s=card_s, host_s=fmt_host_s,
                            h_mean_rows_differing=len(differ), bytes=os.path.getsize(path))
        print("building-formats %s: %d rows (read %d), write %.3f s, read %.3f s, card %.3f s, "
              "host %s; equal to %s (h_mean differing in %d rows) [%s]"
              % (fmt, len(features), rows_read, fmt_write_s, fmt_read_s, card_s,
                 "not run" if fmt_host_s is None else "%.3f s" % fmt_host_s, against,
                 len(differ), card))
    for kernel, n in round_launches.items():
        launches[kernel] += n
    total_s = time.perf_counter() - started
    print("building-formats: %d Gaussian launches on the path (%d tiles and %d format "
          "requests); the phase %.1f s [%s]" % (launches["gaussian_blur"], len(subrequests),
                                               len(formats), total_s, card))
    return launches, dict(
        buildings=count, tiles=len(subrequests), gml_write_s=write_s, gml_read_s=read_s,
        gml_bytes=os.path.getsize(gml), export_s=export_s, exported=exported,
        buildings_per_s=exported / export_s,
        phases=phases, host_s=host_s, h_mean_rows_differing=len(differing),
        square=len(square), formats=numbers, phase_s=total_s)


# --- dem-formats: an SRTM tile and the plain-grid formats ---

#: the SRTM1 tile over Eindhoven and Nijmegen: 1 arc-second, node-registered
DEM_NAME = "N51E005.hgt"
DEM_CORNER = (5, 51)  # longitude, latitude of its south-west corner
DEM_N = 3601
#: the SRTM3 decimation the text formats take (a real SRTM3 tile's size)
DEM_TEXT_N = 1201
DEM_NODATA = -32768
DEM_SMOOTH_M = 100.0  # about three cells of 31 m
DEM_BINS = [10, 20, 30, 40, 60, 80]
#: (b): the tile's footprint in RD New at 25 m cells
DEM_RD_PX = 4096
DEM_RD_CELL = 25.0
DEM_SAMPLED = 8  # tiles a format is held to compute_host on
DEM_FORMATS = ("dt2", "bil", "grd", "sgrd", "rst", "asc", "xyz")


def dem_heights(n=DEM_N, seed=15):
    """Synthetic SRTM heights (int16 metres, rows north to south) over
    N51E005: a plain rising eastward from about 15 to 40 m, the moraine
    near Nijmegen in the north-east up to about 90 m, a valley, 1.5 m of
    noise, and six rectangles of voids (-32768)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, n)
    y, x = t[:, None], t[None, :]
    heights = (15 + 25 * x + 55 * np.exp(-((x - 0.85) ** 2 + (y - 0.15) ** 2) / 0.01)
               - 8 * np.exp(-((y - 0.3 - 0.2 * x) ** 2) / 0.002)
               + 3 * np.sin(40 * x) * np.cos(31 * y) + rng.normal(0, 1.5, (n, n)))
    heights = np.rint(heights).astype(np.int16)
    for _ in range(6):
        r, c = rng.randint(0, n - 40, 2)
        h, w = rng.randint(3, 40, 2)
        heights[r:r + h, c:c + w] = DEM_NODATA
    return heights


def dem_geo_transform(n):
    """The GDAL geotransform of an n^2 SRTM tile at DEM_CORNER (io/dem.py)."""
    res = 1.0 / (n - 1)
    lon, lat = DEM_CORNER
    return (lon - res / 2, res, 0.0, lat + 1 + res / 2, 0.0, -res)


def dem_request(n):
    """The tile's own n^2 grid in EPSG:4326."""
    x0, dx, _, y0, _, dy = dem_geo_transform(n)
    return dict(mode="vals", projection="EPSG:4326", width=n, height=n,
                bbox=(x0, y0 + dy * n, x0 + dx * n, y0))


def dem_rd_request(n=DEM_N, px=DEM_RD_PX, cell=DEM_RD_CELL):
    """A px^2 request of ``cell`` m in EPSG:28992 centred on the tile."""
    from dask_geomodeling_tpu_torch.geo import transform_extent

    x1, y1, x2, y2 = transform_extent(dem_request(n)["bbox"], "EPSG:4326", "EPSG:28992")
    cx, cy = round((x1 + x2) / 2), round((y1 + y2) / 2)
    half = px * cell / 2
    return dict(mode="vals", projection="EPSG:28992", width=px, height=px,
                bbox=(cx - half, cy - half, cx + half, cy + half))


def write_dted(path, heights):
    """A DTED file of ``heights`` (rows north to south) at DEM_CORNER:
    the UHL, DSI and ACC records and one data record per longitude
    column, south to north in sign-magnitude int16 with its checksum;
    voids become DTED's -32767.  Both intervals are 1 arc-second, so
    the grid is the SRTM1 tile's (a level 2 file at 51 degrees north
    would take 2 arc-seconds of longitude)."""
    n_rows, n_cols = heights.shape
    lon, lat = DEM_CORNER
    uhl = bytearray(b" " * 80)
    uhl[0:4] = b"UHL1"
    uhl[4:12] = b"%03d0000E" % lon
    uhl[12:20] = b"%03d0000N" % lat
    uhl[20:24] = b"%04d" % round(36000 / (n_cols - 1))
    uhl[24:28] = b"%04d" % round(36000 / (n_rows - 1))
    uhl[47:51] = b"%04d" % n_cols
    uhl[51:55] = b"%04d" % n_rows
    columns = heights[::-1].T.astype(np.int32)  # (cols, south->north)
    columns[columns == DEM_NODATA] = -32767
    magnitude = np.ascontiguousarray(np.where(columns < 0, -columns | 0x8000, columns), ">u2")
    records = np.zeros((n_cols, 12 + 2 * n_rows), np.uint8)
    records[:, 0] = 0xAA
    index = np.arange(n_cols, dtype=">u4").view(np.uint8).reshape(n_cols, 4)
    records[:, 1:4] = index[:, 1:]  # the block count
    records[:, 4:6] = index[:, 2:]  # the longitude count
    records[:, 8:-4] = magnitude.view(np.uint8).reshape(n_cols, -1)
    checksum = records[:, :-4].astype(np.uint64).sum(axis=1).astype(">u4")
    records[:, -4:] = checksum.view(np.uint8).reshape(n_cols, 4)
    with open(path, "wb") as f:
        f.write(bytes(uhl) + b"DSIU" + b" " * 644 + b"ACC " + b" " * 2696)
        f.write(records.tobytes())


def write_idrisi(path, heights, geo_transform):
    """An Idrisi pair: ``path`` (.rst, little-endian int16 rows north to
    south) and its .rdc, edge-registered, in latlong."""
    n_rows, n_cols = heights.shape
    x0, dx, _, y0, _, dy = geo_transform
    heights.astype("<i2").tofile(path)
    with open(os.path.splitext(path)[0] + ".rdc", "w") as f:
        f.write("file format : IDRISI Raster A.1\nfile title  : %s\ndata type   : integer\n"
                "file type   : binary\ncolumns     : %d\nrows        : %d\n"
                "ref. system : latlong\nref. units  : deg\nunit dist.  : 1.0\n"
                "min. X      : %r\nmax. X      : %r\nmin. Y      : %r\nmax. Y      : %r\n"
                "flag value  : %d\nflag def'n  : missing data\n"
                % (os.path.basename(path), n_cols, n_rows, x0, x0 + dx * n_cols,
                   y0 + dy * n_rows, y0, DEM_NODATA))


def write_ascii_grid(path, heights, geo_transform):
    """An Esri ASCII grid of ``heights`` (corner-registered header)."""
    n_rows, n_cols = heights.shape
    x0, dx, _, y0, _, dy = geo_transform
    with open(path, "w") as f:
        f.write("ncols %d\nnrows %d\nxllcorner %r\nyllcorner %r\ncellsize %r\n"
                "NODATA_value %d\n" % (n_cols, n_rows, x0, y0 + dy * n_rows, dx, DEM_NODATA))
        f.write("\n".join(" ".join(row) for row in heights.astype(str)) + "\n")


def write_xyz(path, heights, geo_transform):
    """XYZ records of ``heights``' cell centres, row by row from the
    north, the voids left out (the reader fills the gaps with nodata)."""
    n_rows, n_cols = heights.shape
    x0, dx, _, y0, _, dy = geo_transform
    xs = ["%r" % (x0 + dx * (c + 0.5)) for c in range(n_cols)]
    with open(path, "w") as f:
        for r in range(n_rows):
            y = "%r" % (y0 + dy * (r + 0.5))
            f.write("".join("%s %s %d\n" % (x, y, z) for x, z in zip(xs, heights[r].tolist())
                            if z != DEM_NODATA))


def write_dem_format(fmt, folder, heights):
    """Write ``heights`` as ``fmt`` into ``folder``; returns the file name
    a RasterFileSource reads.  The port's writers where it has one
    (write_envi as .bil, write_surfer, write_saga), the others composed."""
    from dask_geomodeling_tpu_torch.io.envi import write_envi
    from dask_geomodeling_tpu_torch.io.simplegrids import write_saga, write_surfer

    n = heights.shape[0]
    gt = dem_geo_transform(n)
    name = DEM_NAME if (fmt, n) == ("hgt", DEM_N) else "N51E005_%d.%s" % (n, fmt)
    path = os.path.join(folder, name)
    if fmt == "hgt":
        heights.astype(">i2").tofile(path)
    elif fmt == "dt2":
        write_dted(path, heights)
    elif fmt == "bil":
        write_envi(path, heights[None], geo_transform=gt, projection="EPSG:4326",
                   no_data_value=DEM_NODATA)
    elif fmt == "grd":
        write_surfer(path, heights[None], gt, no_data_value=DEM_NODATA)
    elif fmt == "sgrd":
        write_saga(path, heights[None], gt, no_data_value=DEM_NODATA)
    elif fmt == "rst":
        write_idrisi(path, heights, gt)
    elif fmt == "asc":
        write_ascii_grid(path, heights, gt)
    elif fmt == "xyz":
        write_xyz(path, heights, gt)
    else:
        raise ValueError(fmt)
    return name


def build_dem_view(name):
    """Classify(MovingMax(Smooth(RasterFileSource(name), 100 m), 3), bins):
    height classes of the smoothed local maximum."""
    from dask_geomodeling_tpu_torch import raster as port

    source = port.RasterFileSource(name)
    return port.Classify(port.MovingMax(port.Smooth(source, DEM_SMOOTH_M), 3), DEM_BINS)


def dem_frames(view, request, tiles_in_batch, label):
    """(the Gaussian's frame shape, the moving max's, the sigma, ``label``)
    in a batch of ``tiles_in_batch`` of ``request``'s first tile: MovingMax
    grows the tile by 1 on each side, Smooth that by its margin."""
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    sy, sx = smooth_sigma(view, tile_requests(request, TILE)[0][0])
    my, mx = int(round(3 * sy)), int(round(3 * sx))
    return ((tiles_in_batch, TILE + 2 + 2 * my, TILE + 2 + 2 * mx),
            (tiles_in_batch, TILE + 2, TILE + 2), (sy, sx), label)


def check_dem_kernels(device, frames):
    """Both kernels on int16 frames of each of the dem-formats batch shapes
    ``frames`` ([(Gaussian shape, moving-max shape, sigma, label)]),
    torch.equal to their plain versions; returns the records' numbers at
    the first."""
    import torch

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import (
        gaussian_blur_reference,
        moving_max_reference,
    )

    rng = np.random.RandomState(16)
    records = None
    for gaussian_shape, moving_shape, sigma, label in frames:
        planes = torch.from_numpy(rng.randint(0, 120, gaussian_shape).astype(np.int16)).to(device)
        got = cuda_stencils.gaussian_blur(planes, *sigma, 0)
        want = gaussian_blur_reference(planes, *sigma, 0)
        check(got.dtype == torch.int16 and torch.equal(got, want),
              "gaussian_blur's integer entry differs from its plain version at %s" % label)
        gaussian_err = float((got.double() - want.double()).abs().max())
        maxima = torch.from_numpy(rng.randint(0, 120, moving_shape).astype(np.int16)).to(device)
        maxima[:, ::97, ::89] = np.iinfo(np.int16).min  # MovingMax's stand-in for nodata
        got_max = cuda_stencils.moving_max(maxima, 3)
        want_max = moving_max_reference(maxima, 3)
        check(got_max.dtype == torch.int16 and torch.equal(got_max, want_max),
              "moving_max differs from its plain version at %s" % label)
        max_err = float((got_max.int() - want_max.int()).abs().max())
        print("kernel check: gaussian_blur integer storage int16 %s sigma=(%.6f, %.6f) and "
              "moving_max int16 %s size 3, %s: equal=True max_abs_err=%r, %r"
              % (gaussian_shape, sigma[0], sigma[1], moving_shape, label, gaussian_err, max_err))
        del got, want, got_max, want_max
        if records is None:
            records = (dict(time_gaussian(planes, sigma), max_abs_err=gaussian_err,
                            path="dem-formats (int16)"),
                       dict(time_moving_max(maxima), max_abs_err=max_err,
                            path="dem-formats (int16)"))
    return records


def check_dem_formats(card, device, folder, n=DEM_N, text_n=DEM_TEXT_N, rd_px=DEM_RD_PX,
                      rd_cell=DEM_RD_CELL):
    """The dem-formats phase.  (a) A synthetic SRTM1 tile, N51E005.hgt
    (n^2 int16 metres), under build_dem_view, asked whole at its own grid
    in EPSG:4326 in 512^2 tiles: every tile bitwise equal to compute_host,
    the Gaussian's integer entry and the moving max launched on its int16
    frames.  (b) The same view asked in RD New (rd_px^2 of rd_cell m over
    the tile), within HEADLINE_SHARE of compute_host (check_algebra_path).
    (c) The same heights written as DTED, ENVI (.bil), Surfer, SAGA and
    Idrisi at n^2, and at the SRTM3 decimation (text_n^2) as an .hgt, an
    Esri ASCII grid and XYZ: each read back and asked once on the card at
    its own grid, sampled tiles bitwise to compute_host, and the integer
    formats' whole answer equal to the .hgt view's of the same size (a
    Surfer grid holds float64).  Returns ({kernel: launches of the
    path}, the numbers, the kernels' numbers)."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import pipeline
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    started = time.perf_counter()
    launches = {"gaussian_blur": 0, "moving_max": 0}
    numbers = {}
    with config.set({"geomodeling.root": folder}):
        heights = dem_heights(n)
        t0 = time.perf_counter()
        name = write_dem_format("hgt", folder, heights)
        write_s = time.perf_counter() - t0
        pipeline.clear_read_cache()
        t0 = time.perf_counter()
        data = pipeline.read_geotiff_cached(os.path.join(folder, name))
        read_s = time.perf_counter() - t0
        check(data.array.dtype == np.int16 and np.array_equal(data.array[0], heights),
              "dem-formats: the .hgt read back differs")
        view = build_dem_view(name)
        frame_dtype = view.args[0].dtype
        check(frame_dtype == np.int16, "dem-formats: the frames are %s, not int16" % frame_dtype)

        # (a) the tile at its own grid
        request = dem_request(n)
        values, path_launches, batches, card_s, host_s = compare_tiles(
            "dem-formats (a) %s" % name, device, view, request, share=0.0)
        for kernel, count in path_launches.items():
            check(count > 0, "dem-formats: %s did not launch on the int16 frames" % kernel)
            launches[kernel] += count
        tiles = tile_requests(request, TILE)[0]
        native_frames = dem_frames(view, request, -(-len(tiles) // batches),
                                   "the native grid's first batch")
        numbers["hgt"] = dict(n=n, write_s=write_s, read_s=read_s, card_s=card_s, host_s=host_s,
                              batches=batches, bytes=data.array.nbytes)
        answers = {n: values}

        # (b) the tile in RD New
        rd_request = dem_rd_request(n, rd_px, rd_cell)
        cuda_stencils.reset_launches()
        t0 = time.perf_counter()
        rd_host, _ = check_algebra_path(
            "dem-formats (b) RD", device, view, rd_request, "nearest",
            (rd_request["bbox"][0], rd_request["bbox"][3]), share=HEADLINE_SHARE)
        numbers["rd"] = dict(seconds=time.perf_counter() - t0, host_mpx_per_s=rd_host)
        for kernel, count in (("gaussian_blur", cuda_stencils.launches),
                              ("moving_max", cuda_stencils.moving_max_launches)):
            check(count > 0, "dem-formats (b): %s did not launch" % kernel)
            launches[kernel] += count
        rd_frames = dem_frames(view, rd_request, BATCH, "the RD batch")

        # (c) the formats, the text ones at the SRTM3 decimation
        text_heights = heights[:: (n - 1) // (text_n - 1), :: (n - 1) // (text_n - 1)]
        for fmt in ("hgt",) + DEM_FORMATS:
            grid = text_heights if fmt in ("hgt", "asc", "xyz") else heights
            size = grid.shape[0]
            t0 = time.perf_counter()
            name = write_dem_format(fmt, folder, grid)
            fmt_write_s = time.perf_counter() - t0
            path = os.path.join(folder, name)
            pipeline.clear_read_cache()
            t0 = time.perf_counter()
            data = pipeline.read_geotiff_cached(path)
            fmt_read_s = time.perf_counter() - t0
            fmt_request = dem_request(size)
            tiles = tile_requests(fmt_request, TILE)[0]
            sampled = list(range(0, len(tiles), max(1, len(tiles) // DEM_SAMPLED)))[:DEM_SAMPLED]
            values, fmt_launches, _, fmt_card_s, fmt_host_s = compare_tiles(
                "dem-formats (c) %s" % name, device, build_dem_view(name), fmt_request,
                share=0.0, sampled=sampled)
            for kernel, count in fmt_launches.items():
                launches[kernel] += count
            answers.setdefault(size, values)
            integer = data.array.dtype.kind in "iu"
            check(not integer or np.array_equal(values, answers[size]),
                  "dem-formats %s: the answer differs from the .hgt view's" % fmt)
            # the format's files (a pair's header too), removed once measured
            stem = os.path.splitext(name)[0] + "."
            files = [os.path.join(folder, f) for f in os.listdir(folder) if f.startswith(stem)]
            n_bytes = sum(os.path.getsize(f) for f in files)
            for f in files:
                os.remove(f)
            numbers[fmt if grid is heights else fmt + "3"] = dict(
                n=size, dtype=str(data.array.dtype), write_s=fmt_write_s, read_s=fmt_read_s,
                card_s=fmt_card_s, host_s=fmt_host_s, bytes=n_bytes)
            print("dem-formats %s: %d^2 %s, %d bytes, write %.3f s, read %.3f s, card %.3f s, "
                  "host %.3f s (%d tiles); equal to compute_host%s [%s]"
                  % (fmt, size, data.array.dtype, n_bytes, fmt_write_s, fmt_read_s, fmt_card_s,
                     fmt_host_s, len(sampled), " and to the .hgt view's answer" if integer else "",
                     card))
    pipeline.clear_read_cache()
    kernels = check_dem_kernels(device, [rd_frames, native_frames])
    total_s = time.perf_counter() - started
    print("dem-formats: %d Gaussian and %d moving-max launches on the path; the phase %.1f s "
          "[%s]" % (launches["gaussian_blur"], launches["moving_max"], total_s, card))
    numbers["phase_s"] = total_s
    return launches, numbers, kernels


def compare_tiles(label, device, view, request, share=HEADLINE_SHARE, sampled=None):
    """``view`` over ``request`` through evaluate_tiled on the card, held
    tile by tile to compute_host (a stencil's answer depends on the
    request window), every tile or those of ``sampled``: at most ``share``
    of the cells differing.  Returns (the values, {kernel: launches},
    batches, card s, host s)."""
    import torch

    from dask_geomodeling_tpu_torch import evaluate_tiled
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    before = (cuda_stencils.launches, cuda_stencils.moving_max_launches,
              tile_runtime.batches_run)
    t0 = time.perf_counter()
    result = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {"gaussian_blur": cuda_stencils.launches - before[0],
                "moving_max": cuda_stencils.moving_max_launches - before[1]}
    batches = tile_runtime.batches_run - before[2]
    values = result["values"]
    tiles, nx = tile_requests(request, TILE)
    picks = range(len(tiles)) if sampled is None else sampled
    differing = cells = 0
    t0 = time.perf_counter()
    for k in picks:
        (rows, cols), (host_rows, host_cols) = tile_cells(
            k, nx, request["width"], request["height"], TILE)
        host = host_values(view, tiles[k])[:, host_rows, host_cols]
        differing += int(np.count_nonzero(values[:, rows, cols] != host))
        cells += host.size
    host_s = time.perf_counter() - t0
    data_share = float((values != result["no_data_value"]).mean())
    print("%s: %s %s, %d tiles in %d batches, %d Gaussian and %d moving-max launches, card "
          "%.3f s, data in %.4f of the cells; %d tiles against compute_host (%.3f s): %d of %d "
          "cells differ (share %r)" % (label, values.shape, values.dtype, len(tiles), batches,
                                       launches["gaussian_blur"], launches["moving_max"], card_s,
                                       data_share, len(picks), host_s, differing, cells,
                                       differing / cells))
    check(values.shape == (1, request["height"], request["width"]), "%s: output shape" % label)
    check(launches["gaussian_blur"] > 0, "%s: the Gaussian did not launch" % label)
    check(data_share > 0.01, "%s: output is all nodata" % label)
    check(differing <= share * cells, "%s: differing share above %g" % (label, share))
    return values, launches, batches, card_s, host_s


def check_crs_families(device, folder, px=FAMILY_PX):
    """crs-families: the headline's chain over a px^2 source in each CRS
    of CRS_FAMILIES, requested in EPSG:3857 at px^2 on the card, each
    against compute_host; then an RD New source with a synthetic NTv2 grid
    registered for the Amersfoort datum, against compute_host under the
    same setting.  Returns the Gaussian launches."""
    from dask_geomodeling_tpu_torch.config import config
    from dask_geomodeling_tpu_torch.geo import transform_points

    launched = 0
    for label, projection, place in CRS_FAMILIES:
        view, request = build_family_view(projection, place, px)
        launched += compare_tiles("crs-families %s (%s)" % (label, projection[:24]), device,
                                  view, request)[1]["gaussian_blur"]
    grid = os.path.join(folder, "amersfoort.gsb")
    write_amersfoort_grid(grid)
    view, request = build_family_view(*NTV2_PLACE, px)
    x1, y1, x2, y2 = request["bbox"]
    centre = ([(x1 + x2) / 2], [(y1 + y2) / 2])
    helmert = transform_points(*centre, "EPSG:3857", "EPSG:28992")
    with config.set({"geomodeling.ntv2-grids": {"Amersfoort": grid}}):
        shifted = transform_points(*centre, "EPSG:3857", "EPSG:28992")
        launched += compare_tiles("crs-families ntv2 (EPSG:28992, Amersfoort grid)", device,
                                  view, request)[1]["gaussian_blur"]
    moved = float(np.hypot(shifted[0][0] - helmert[0][0], shifted[1][0] - helmert[1][0]))
    print("crs-families ntv2: the grid moves the request's centre by %.4f m from the "
          "Helmert answer" % moved)
    check(moved > 0.01, "crs-families ntv2: the grid was not applied")
    return launched


#: border-reproject's source: 2048^2 cells of 4 m over the 8192 m square
#: an 8192^2 source of 1 m covered (its 17-digit floats took 77 s through
#: JSON on the card machine, 4096^2 of 2 m 17-22 s; a sixteenth of the
#: cells take a sixteenth)
BORDER_PX = 2048
BORDER_CELL = 4.0


def check_border(px=BORDER_PX, cell=BORDER_CELL):
    """border-reproject, before its tiled run: the view sent through JSON
    keeps its token.  Returns (the loaded view, its request, the JSON
    round trip's seconds)."""
    t0 = time.perf_counter()
    view, loaded = build_border_view(px, cell)
    json_s = time.perf_counter() - t0
    check(loaded.token == view.token, "border-reproject: the JSON view's token differs")
    request = border_request(loaded, HEADLINE_PX)
    source = loaded
    while type(source).__name__ != "MemorySource":
        source = source.args[0]
    print("border-reproject: %d^2 EPSG:25832 source of %g m cells through to_json and "
          "from_json in %.2f s (token kept, the source's data %s); request %r in EPSG:28992 at "
          "%d^2" % (px, cell, json_s, source.data.dtype, request["bbox"], HEADLINE_PX))
    return loaded, request, json_s


def check_nesting(device):
    """The two Cumulative nestings at 1024^2 on the card: get_data and
    evaluate_tiled bitwise to compute_host, and their time answers."""
    from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
    from dask_geomodeling_tpu_torch.runtime import executor

    views, request = build_nesting_views()
    host_runs = executor.host_node_runs
    for label, view in views.items():
        expected = compute_host(*view.get_compute_graph(**request))
        whole = view.get_data(device=device, **request)
        tiled = evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device)
        for name, actual in (("get_data", whole), ("evaluate_tiled", tiled)):
            check(actual["values"].dtype == expected["values"].dtype
                  and np.array_equal(actual["values"], expected["values"]),
                  "cumulative-nesting %s: %s differs from compute_host" % (label, name))
        time_request = dict(request, mode="time")
        check(view.get_data(device=device, **time_request)
              == compute_host(*view.get_compute_graph(**time_request)),
              "cumulative-nesting %s: the time answer differs" % label)
        print("cumulative-nesting %s: %s %s, get_data and evaluate_tiled bitwise to "
              "compute_host, time answer equal" % (label, whole["values"].shape,
                                                  whole["values"].dtype))
    check(executor.host_node_runs == host_runs, "cumulative-nesting: a node ran on the host")


def check_json_integer(device, px=1024):
    """A uint8 MemorySource + 1 loaded from JSON answers int64 on the card,
    as compute_host does (construction without validation keeps the
    integer list as int64), with the built view's token."""
    from dask_geomodeling_tpu_torch import Block, compute_host
    from dask_geomodeling_tpu_torch.raster import MemorySource

    data = np.random.RandomState(3).randint(0, 255, (1, px, px)).astype(np.uint8)
    view = MemorySource(data=data, no_data_value=255, projection="EPSG:28992",
                        pixel_size=1.0, pixel_origin=(135000.0, 456000.0)) + 1
    loaded = Block.from_json(view.to_json())
    request = dict(mode="vals", bbox=(135000.0, 456000.0 - px, 135000.0 + px, 456000.0),
                   projection="EPSG:28992", width=px, height=px, start=datetime(1970, 1, 1))
    card = loaded.get_data(device=device, **request)
    host = compute_host(*loaded.get_compute_graph(**request))
    print("json-integer: a uint8 source + 1 from JSON answers %s on the card, %s on the host"
          % (card["values"].dtype, host["values"].dtype))
    check(loaded.token == view.token, "json-integer: the token differs")
    check(card["values"].dtype == host["values"].dtype == np.int64,
          "json-integer: not int64")
    check(np.array_equal(card["values"], host["values"]), "json-integer: values differ")


def check_fuzz(device):
    """The executor fuzz on the card: the reference's random trees (seeds
    0-39 at 12^2, 40-54 as 6^2 tiles in batches of 2) against compute_host
    with the fuzz's rule; returns the number of trees checked."""
    from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
    from dask_geomodeling_tpu_torch.runtime import executor

    sources = fuzz_sources()
    host_runs = executor.host_node_runs
    failed = []
    exact_floats = 0
    for seed in list(FUZZ_SEEDS) + list(FUZZ_TILED_SEEDS):
        view, request = fuzz_view(seed, sources)
        expected = compute_host(*view.get_compute_graph(**request))
        if seed in FUZZ_TILED_SEEDS:
            actual = evaluate_tiled(view, request, tile_size=6, batch=2, device=device)
            actual = dict(actual, no_data_value=expected["no_data_value"])
        else:
            actual = view.get_data(device=device, **request)
        if not same_as_host(actual, expected):
            failed.append(seed)
        elif expected is not None and expected["values"].dtype.kind == "f":
            exact_floats += int(np.array_equal(actual["values"], expected["values"]))
    check(executor.host_node_runs == host_runs, "fuzz: a node ran on the host")
    n = len(FUZZ_SEEDS) + len(FUZZ_TILED_SEEDS)
    print("fuzz: %d random trees on the card against compute_host, %d failed %s; %d float "
          "results bitwise" % (n, len(failed), failed, exact_floats))
    check(not failed, "fuzz: seeds %s differ from compute_host" % failed)
    return n


def check_f64_discrete(device):
    """The float64 discrete ops on the card, bitwise against compute_host:
    comparisons, MaskBelow, Step and Classify on a float64 source whose
    values sit on and one float64 step beside each threshold."""
    from dask_geomodeling_tpu_torch import compute_host
    from dask_geomodeling_tpu_torch import raster as R

    thresholds = [0.1, 1 / 3, 12.34, 100.0, 2.0 ** 40 + 0.5, -7.7]
    near = np.array([np.nextafter(t, d) for t in thresholds for d in (-np.inf, 0.0, np.inf)]
                    + [t for t in thresholds])
    rng = np.random.RandomState(3)
    values = rng.choice(near, size=(64, 64))
    source = R.MemorySource(data=values, no_data_value=-9999.0, projection="EPSG:28992",
                            pixel_size=1.0, pixel_origin=(0.0, 64.0))
    request = dict(mode="vals", bbox=(0.0, 0.0, 64.0, 64.0), projection="EPSG:28992",
                   width=64, height=64, start=datetime(1970, 1, 1))
    views = []
    for t in thresholds:
        views += [cls(source, t) for cls in (R.Greater, R.GreaterEqual, R.Less, R.LessEqual,
                                             R.Equal, R.NotEqual, R.MaskBelow)]
        views.append(R.Step(source, left=0, right=2, value=t, at=1))
    views.append(R.Classify(source, bins=sorted(thresholds)))
    differing = [repr(v)[:40] for v in views
                 if not np.array_equal(v.get_data(device=device, **request)["values"],
                                       compute_host(*v.get_compute_graph(**request))["values"])]
    print("f64 discrete: %d float64 views (comparisons, MaskBelow, Step, Classify) at and "
          "beside %d thresholds: %d differ from compute_host" % (len(views), len(thresholds),
                                                                  len(differing)))
    check(not differing, "f64 discrete ops differ: %s" % differing[:3])
    return len(views)


def time_path(label, card, view, request, device, host_rate):
    """Phase 9 for one path; returns its numbers."""
    import torch

    from dask_geomodeling_tpu_torch import evaluate_tiled

    runs, run_phases = [], []
    for _ in range(3):
        run_phases.append({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                       phase_seconds=run_phases[-1])
        runs.append(time.perf_counter() - t0)
    median = sorted(range(3), key=runs.__getitem__)[1]
    rate = request["width"] * request["height"] / 1e6 / runs[median]
    phases = run_phases[median]
    profiled_s, busy_ms = device_busy_ms(lambda: evaluate_tiled(
        view, request, tile_size=TILE, batch=BATCH, device=device))
    idle = None if busy_ms is None else 1 - busy_ms / 1e3 / profiled_s
    print("timing [%s] %s: port %.3f Mpx/s (median of 3: %s s); numpy host %.3f Mpx/s on the "
          "sampled tiles" % (card, label, rate, ", ".join("%.3f" % r for r in runs), host_rate))
    print("timing [%s] %s: phases of the median run (synchronised): %s"
          % (card, label, ", ".join("%s %.4f s" % kv for kv in phases.items())))
    print("timing [%s] %s: profiled run %.4f s, device busy %s, idle share %s"
          % (card, label, profiled_s,
             "not measured" if busy_ms is None else "%.3f ms" % busy_ms,
             "not measured" if idle is None else "%.4f" % idle))
    return dict(mpx_per_s=rate, runs_s=runs, host_mpx_per_s=host_rate, phases_s=phases,
                device_busy_ms=busy_ms, idle_share=idle)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    started = time.perf_counter()

    def mark(phase):
        print("elapsed: %.1f s after %s" % (time.perf_counter() - started, phase))

    # 1. device
    card = card_description()
    device = torch.device("cuda", 0)
    print(card)
    print("device: torch %s, CUDA %s, %d card(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    # 2. build
    build_kernels()
    mark("the build")
    folder = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(card, device, folder, mark)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def run_phases(card, device, folder, mark):
    """Phases 3 to 12; ``folder`` holds the sheet and the exports."""
    import torch

    from dask_geomodeling_tpu_torch import evaluate_tiled, native
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
    from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

    t0 = time.perf_counter()
    sheet = write_sheet(folder)
    print("file paths: the %dx%d float32 sheet written (deflate, 512^2 tiles) in %.2f s, %d MB"
          % (SHEET_WIDTH, SHEET_HEIGHT, time.perf_counter() - t0,
             os.path.getsize(sheet) // 10**6))
    files = build_file_paths(sheet)
    mark("writing the sheet")

    # 3. kernel checks, at the sigmas of the paths' first tiles
    headline_source, headline_view = build_headline_view()
    headline_req = headline_request(headline_source, HEADLINE_PX)
    _, stencils_view = build_stencils_view(STENCILS_PX)
    stencils_req = vals_request(STENCILS_PX)
    sigmas = [smooth_sigma(view, tile_requests(req, TILE)[0][0])
              for view, req in [(headline_view, headline_req), (stencils_view, stencils_req),
                                files["file-read"][:2]]]
    gaussian = check_gaussian(device, *sigmas)
    moving = check_moving_max(device)
    mark("the kernel checks")

    # 4. to 8. the paths, the fuzz and the float64 discrete ops
    headline_launches, headline_host = check_headline(
        device, headline_source, headline_view, headline_req)
    stencils_launches, stencils_host = check_stencils(device, stencils_view, stencils_req)
    launches = {"headline": headline_launches, "stencils": stencils_launches}
    mark("the headline and stencils paths")
    border_view, border_req, border_json_s = check_border()
    cuda_stencils.reset_launches()
    border_host, _ = check_algebra_path(
        "border-reproject", device, border_view, border_req, "nearest",
        (border_req["bbox"][0], border_req["bbox"][3]), share=HEADLINE_SHARE, sigma_groups=True)
    launches["border-reproject"] = {"gaussian_blur": cuda_stencils.launches,
                                    "moving_max": cuda_stencils.moving_max_launches}
    check(launches["border-reproject"]["gaussian_blur"] > 0,
          "border-reproject: the Gaussian did not launch")
    mark("the border-reproject path")
    cuda_stencils.reset_launches()
    check_crs_families(device, folder)
    launches["crs-families"] = {"gaussian_blur": cuda_stencils.launches,
                                "moving_max": cuda_stencils.moving_max_launches}
    for label, phase in (("cumulative-nesting", check_nesting),
                         ("json-integer", check_json_integer)):
        cuda_stencils.reset_launches()
        phase(device)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    mark("the crs-families, cumulative-nesting and json-integer phases")
    algebra = build_algebra_paths(ALGEBRA_PX)
    algebra_host = {}
    for label, (view, request, interpolation, corner) in algebra.items():
        cuda_stencils.reset_launches()
        algebra_host[label], _ = check_algebra_path(
            label, device, view, request, interpolation, corner)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    mark("the algebra paths")
    temporal, hourly48 = build_temporal_paths()
    mark("building the temporal sources")
    for label, (view, request, interpolation, corner) in temporal.items():
        cuda_stencils.reset_launches()
        # the 48-frame paths' host takes about a second a tile: 4 tiles,
        # and 8 of temporal-mean's
        algebra_host[label], _ = check_algebra_path(
            label, device, view, request, interpolation, corner,
            sampled_tiles=8 if label == "temporal-mean" else 4)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
    check(launches["temporal-median"]["moving_max"] > 0,
          "temporal-median: the moving-max kernel did not launch")
    check_temporal_p90(device, hourly48, temporal["temporal-median"][1])
    mark("the temporal paths")
    geometry = build_geometry_paths()
    for label, (view, request, interpolation, corner) in geometry.items():
        cuda_stencils.reset_launches()
        native.reset_counts()
        with native_spy() as spy:
            algebra_host[label], _ = check_algebra_path(
                label, device, view, request, interpolation, corner,
                host_nodes=1 if label == "rasterize" else 0)
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
        if label == "rasterize":
            check_native_only("rasterize", spy)
            check(native.counts["burns"] > 0, "rasterize: no native burn")
            print("rasterize path: %d native burns, no numpy polygon scanline"
                  % native.counts["burns"])
            check_rasterize_burns(card, view, request)
    view, request, _, _ = geometry["rasterize-wkt"]
    wkt_ms = time_rasterize_wkt(device, view, request)
    print("timing [%s] rasterize-wkt: the parity twin over one batch of %d 512^2 tiles "
          "(CUDA events): %.4f ms" % (card, BATCH, wkt_ms))
    mark("the tiled geometry paths")
    cuda_stencils.reset_launches()
    zonal = check_zonal(device, card, temporal["temporal-mean"][0])
    launches["zonal"] = {"gaussian_blur": cuda_stencils.launches,
                         "moving_max": cuda_stencils.moving_max_launches}
    mark("the zonal path")
    file_host = {}
    for label, (view, request, interpolation, corner) in files.items():
        cuda_stencils.reset_launches()
        # file-read runs no second whole run (get_data against
        # evaluate_tiled): file-reproject holds it for the same view
        file_host[label], values = check_algebra_path(
            label, device, view, request, interpolation, corner,
            share=0.0 if label == "file-read" else HEADLINE_SHARE,
            sigma_groups=label == "file-reproject", routed=label != "file-read")
        launches[label] = {"gaussian_blur": cuda_stencils.launches,
                           "moving_max": cuda_stencils.moving_max_launches}
        if label == "file-read":
            read_values = values
        del values
    mark("the file-read and file-reproject paths")
    launches["zarr-store"], zarr_store = check_zarr_store(card, device, folder, sheet,
                                                          files["file-read"], read_values)
    mark("the zarr-store path")
    view, request, _, _ = files["file-read"]
    launches["file-export"], export = check_file_export(card, device, view, request, folder,
                                                        read_values)
    mark("the file-export path")
    launches["building-heights"], buildings = check_buildings(card, device, folder, sheet)
    rng = np.random.RandomState(1)
    building_planes = torch.from_numpy(
        (3 + rng.rand(*buildings["plane"]) * 5).astype(np.float32)).to(device)
    got = cuda_stencils.gaussian_blur(building_planes, *buildings["sigma"], 0)
    want = gaussian_blur_reference(building_planes, *buildings["sigma"], 0)
    check(torch.equal(got, want),
          "gaussian_blur differs from its plain version at the building-heights plane")
    err = float((got - want).abs().max())
    print("kernel check: gaussian_blur building-heights plane %s equal=True max_abs_err=%r"
          % (tuple(building_planes.shape), err))
    gaussian.append(dict(time_gaussian(building_planes, buildings["sigma"]),
                         max_abs_err=err, path="building-heights"))
    del building_planes, got, want
    mark("the building-heights path")
    launches["wms-serving"], wms = check_wms_serving(card, device, sheet)
    wms_planes = torch.from_numpy(
        (3 + rng.rand(*wms["plane"]) * 5).astype(np.float32)).to(device)
    got = cuda_stencils.gaussian_blur(wms_planes, *wms["sigma"], 0)
    want = gaussian_blur_reference(wms_planes, *wms["sigma"], 0)
    check(torch.equal(got, want), "gaussian_blur differs from its plain version at the WMS plane")
    err = float((got - want).abs().max())
    print("kernel check: gaussian_blur wms-serving plane %s equal=True max_abs_err=%r"
          % (tuple(wms_planes.shape), err))
    gaussian.append(dict(time_gaussian(wms_planes, wms["sigma"]), max_abs_err=err,
                         path="wms-serving"))
    del wms_planes, got, want
    mark("the wms-serving path")
    launches["auto-routing"], auto = check_auto_routing(card, device, folder, sheet,
                                                        headline_view, headline_req)
    mark("the auto-routing path")
    launches["building-rings"], rings = check_building_rings(card, device, folder, sheet)
    mark("the building-rings path")
    launches["building-formats"], formats = check_building_formats(card, device, folder, sheet)
    check(launches["building-formats"]["gaussian_blur"] > 0,
          "building-formats: the Gaussian did not launch")
    mark("the building-formats path")
    launches["dem-formats"], dem, dem_kernels = check_dem_formats(card, device, folder)
    gaussian.append(dem_kernels[0])
    moving.append(dem_kernels[1])
    mark("the dem-formats path")
    launches["netcdf-radar"], radar, (radar_planes, radar_sigma) = check_netcdf_radar(
        card, device, folder)
    planes = torch.from_numpy((rng.rand(*radar_planes) * 5).astype(np.float32)).to(device)
    got = cuda_stencils.gaussian_blur(planes, *radar_sigma, 0)
    want = gaussian_blur_reference(planes, *radar_sigma, 0)
    check(torch.equal(got, want), "gaussian_blur differs from its plain version at the "
          "netcdf-radar batch")
    err = float((got - want).abs().max())
    print("kernel check: gaussian_blur netcdf-radar batch %s sigma=(%.6f, %.6f) equal=True "
          "max_abs_err=%r" % (tuple(planes.shape), radar_sigma[0], radar_sigma[1], err))
    gaussian.append(dict(time_gaussian(planes, radar_sigma), max_abs_err=err, path="netcdf-radar"))
    del planes, got, want
    mark("the netcdf-radar path")
    launches["hfa-roughness"], roughness, roughness_kernel, lgn = check_hfa_roughness(
        card, device, folder)
    gaussian.append(roughness_kernel)
    mark("the hfa-roughness path")
    lzw_lgn = dict(lgn)  # tile-pyramids takes its arrays out of lgn; lzw-sheet reads them too
    launches["tile-pyramids"], pyramids = check_tile_pyramids(card, device, folder, lgn)
    mark("the tile-pyramids path")
    launches["modis-ndvi"], modis = check_modis_ndvi(card, device, folder)
    mark("the modis-ndvi path")
    launches["grib-forecast"], forecast, forecast_kernels = check_grib_forecast(
        card, device, folder)
    gaussian.extend(forecast_kernels)
    mark("the grib-forecast path")
    launches["parcel-imagery"], parcels, parcel_kernels = check_parcel_imagery(
        card, device, folder)
    gaussian.extend(parcel_kernels)
    mark("the parcel-imagery path")
    launches["lzw-sheet"], lzw, lzw_kernels = check_lzw_sheet(
        card, device, folder, sheet, files["file-read"], read_values, lzw_lgn)
    gaussian.extend(lzw_kernels)
    del read_values, lzw_lgn
    mark("the lzw-sheet path")
    t0 = time.perf_counter()
    ortho_px = ortho_pixels(ORTHO_PX, ORTHO_PX)  # shared by ortho-jpeg and ortho-webp
    print("ortho-jpeg and ortho-webp: the %d^2 RGB orthophoto drawn in %.2f s"
          % (ORTHO_PX, time.perf_counter() - t0))
    launches["ortho-jpeg"], ortho, ortho_kernels = check_ortho_jpeg(card, device, folder,
                                                                    pixels=ortho_px)
    gaussian.extend(ortho_kernels)
    mark("the ortho-jpeg path")
    launches["ortho-webp"], ortho_webp, ortho_webp_kernels = check_ortho_webp(
        card, device, folder, pixels=ortho_px)
    del ortho_px
    gaussian.extend(ortho_webp_kernels)
    mark("the ortho-webp path")
    check_fuzz(device)
    check_f64_discrete(device)
    mark("the fuzz and the float64 discrete ops")

    # 9. timing
    timings = {
        "headline": time_path("headline", card, headline_view, headline_req, device, headline_host),
        "border-reproject": time_path("border-reproject", card, border_view, border_req, device,
                                      border_host),
        "stencils": time_path("stencils", card, stencils_view, stencils_req, device, stencils_host),
    }
    timings["border-reproject"]["json_s"] = border_json_s
    print("timing [%s] border-reproject: plan %.4f s against the headline's %.4f s (one run "
          "each, synchronised)" % (card, timings["border-reproject"]["phases_s"]["plan"],
                                   timings["headline"]["phases_s"]["plan"]))
    algebra_host.update(file_host)
    for label, (view, request, interpolation, _) in (
            list(algebra.items()) + list(temporal.items()) + list(geometry.items())
            + list(files.items())):
        with interpolation_set(interpolation):
            timings[label] = time_path(label, card, view, request, device, algebra_host[label])
    view, request, _, _ = geometry["rasterize"]
    numpy_phases = {}
    with numpy_scanline():
        evaluate_tiled(view, request, tile_size=TILE, batch=BATCH, device=device,
                       phase_seconds=numpy_phases)
    timings["rasterize"]["numpy_scanline_phases_s"] = numpy_phases
    print("timing [%s] rasterize: plan %.4f s with the native burn (the median run) against "
          "%.4f s with the numpy scanline (one run)" % (
              card, timings["rasterize"]["phases_s"]["plan"], numpy_phases["plan"]))
    timings["file-export"] = export
    timings["zarr-store"] = zarr_store
    timings["building-heights"] = buildings
    timings["wms-serving"] = wms
    timings["auto-routing"] = auto
    timings["building-rings"] = rings
    timings["building-formats"] = formats
    timings["dem-formats"] = dem
    timings["netcdf-radar"] = radar
    timings["hfa-roughness"] = roughness
    timings["tile-pyramids"] = pyramids
    timings["modis-ndvi"] = modis
    timings["grib-forecast"] = forecast
    timings["parcel-imagery"] = parcels
    timings["lzw-sheet"] = lzw
    timings["ortho-jpeg"] = ortho
    timings["ortho-webp"] = ortho_webp
    for name, numbers in [("gaussian_blur", g) for g in gaussian] + [("moving_max", m) for m in moving]:
        print("timing [%s]: %s %s kernel %.4f ms, plain torch %.4f ms, library call %.4f ms, "
              "bound %.4f ms (%s)" % (card, name, tuple(numbers["shape"]), numbers["ms"],
                                      numbers["plain_ms"], numbers["library_ms"],
                                      numbers["bound_ms"], numbers["bound_by"]))

    mark("the timing")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "dask_geomodeling_tpu", "pandas", "matplotlib", "PIL", "flatbuffers"))
    check(not leaked, "modules of JAX, pandas, matplotlib, Pillow, flatbuffers or the JAX "
          "package were imported: %s" % leaked[:5])
    print("imports: no module of JAX, pandas, matplotlib, Pillow, flatbuffers or the JAX "
          "package was loaded")
    timings["zonal"] = zonal
    timings["rasterize-wkt"]["parity_twin_ms"] = wkt_ms
    print("paths: %s" % json.dumps(timings))

    def record(name, source, replaces, numbers, kernel):
        per_path = {label: counts[kernel] for label, counts in launches.items()}
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(per_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": numbers["max_abs_err"],
            "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"],
            "shape": numbers["shape"],
            "timed_at": numbers["path"],
        }

    print(json.dumps({"kernels": [
        record("gaussian_blur", "dask_geomodeling_tpu_torch/csrc/gaussian_blur.cu",
               "dask_geomodeling_tpu/ops/pallas_stencils.py:55", numbers, "gaussian_blur")
        for numbers in gaussian
    ] + [
        record("moving_max", "dask_geomodeling_tpu_torch/csrc/moving_max.cu",
               "dask_geomodeling_tpu/ops/pallas_stencils.py:136", numbers, "moving_max")
        for numbers in moving
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
