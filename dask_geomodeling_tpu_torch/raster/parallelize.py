"""RasterTiler: split a vals request into tiles and reassemble them.

Counterpart of dask_geomodeling_tpu/raster/parallelize.py: a vals request
splits into a grid of subrequests of at most ``tile_size`` pixels each
(edge tiles truncate, the cell size is kept exactly), and the partial
rasters reassemble into the requested window with the world-y/array-row
flip.  The reassembly is a host process over fetched inputs
(``torch_fetch_inputs``): ``compute_torch`` runs each subrequest's chain
of twins on the device and copies each result to the host once.  The
tile runtime's own 512^2 grid is not this one: a view with a tiler at its
root runs whole through ``compute_torch``.
"""
import numpy as np

from dask_geomodeling_tpu_torch.raster.base import BaseSingle

__all__ = ["RasterTiler"]


def _tile_edges(lo, hi, step):
    """World coordinates of tile boundaries covering [lo, hi]."""
    edges = list(np.arange(lo, hi, step))
    edges.append(hi)
    if len(edges) > 1 and edges[-2] == hi:
        edges.pop()
    return edges


class RasterTiler(BaseSingle):
    """Split vals requests into tiles of at most ``tile_size`` pixels.

    Args:
      source (RasterBlock): source raster
      tile_size (int or [width, height]): maximum tile size in pixels
    """

    def __init__(self, source, tile_size):
        if not hasattr(tile_size, "__iter__"):
            tile_size = (tile_size, tile_size)
        elif len(tile_size) != 2:
            raise ValueError("'tile_size' should be a scalar or a list of length 2.")
        tile_size = [int(x) for x in tile_size]
        if min(tile_size) <= 0:
            raise ValueError("'tile_size' should be greater than 0")
        super().__init__(source, tile_size)

    @property
    def tile_size(self):
        return self.args[1]

    def _plan_tiles(self, request):
        """Yield (col, row, subrequest) covering the requested window."""
        x1, y1, x2, y2 = request["bbox"]
        cell_w = (x2 - x1) / request["width"]
        cell_h = (y2 - y1) / request["height"]
        xs = _tile_edges(x1, x2, cell_w * self.tile_size[0])
        ys = _tile_edges(y1, y2, cell_h * self.tile_size[1])
        for col in range(len(xs) - 1):
            for row in range(len(ys) - 1):
                bbox = (xs[col], ys[row], xs[col + 1], ys[row + 1])
                yield col, row, {
                    **request,
                    "bbox": bbox,
                    "width": int(round((bbox[2] - bbox[0]) / cell_w)),
                    "height": int(round((bbox[3] - bbox[1]) / cell_h)),
                }

    def get_sources_and_requests(self, **request):
        if request["mode"] != "vals":
            return [(None, None), (self.store, request)]

        x1, y1, x2, y2 = request["bbox"]
        if x1 == x2 and y1 == y2:
            # point requests pass through untiled
            return [(None, None), (self.store, request)]

        subrequests = list(self._plan_tiles(request))
        plan = {
            "dtype": self.dtype,
            "fillvalue": self.fillvalue,
            "out_height": request["height"],
            "out_width": request["width"],
            # bottom-left pixel offset of each tile in the output grid
            "offsets": [
                (col * self.tile_size[0], row * self.tile_size[1])
                for col, row, _ in subrequests
            ],
        }
        return [(plan, None)] + [(self.store, subrequest) for _, _, subrequest in subrequests]

    @staticmethod
    def process(plan, *tiles):
        if len(tiles) == 0:
            return None
        if plan is None:
            return tiles[0]  # point / meta / time requests pass through

        bands = next((t["values"].shape[0] for t in tiles if t is not None), None)
        if bands is None:
            return None

        out_h, out_w = plan["out_height"], plan["out_width"]
        mosaic = np.full((bands, out_h, out_w), plan["fillvalue"], plan["dtype"])
        for (x_off, y_off), tile in zip(plan["offsets"], tiles):
            if tile is None:
                continue
            part = tile["values"]
            # world y grows upward while rows grow downward: a tile whose
            # bottom-left sits y_off pixels up fills rows ending at
            # out_h - y_off
            row_end = out_h - y_off
            row_start = row_end - part.shape[1]
            mosaic[:, row_start:row_end, x_off : x_off + part.shape[2]] = part
        return {"values": mosaic, "no_data_value": plan["fillvalue"]}


RasterTiler.process.torch_fetch_inputs = True
