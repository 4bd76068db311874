"""Typed columns out of free-text metadata.

Counterpart of dask_geomodeling_tpu/geometry/text.py: ``ParseTextColumn``
lifts chosen keys out of a column of newline-separated ``key=value``
lines into typed columns of their own, with the same grammar, the same
null/bool/float casting, NaN for a missing key, and one parse per
distinct text.  A new column is typed as pandas infers a series from the
list of its cells (geo/features.py); a column where no row has a value
is a float64 NaN column.  A host node: it runs its numpy process.
"""
import re

import numpy as np

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import Series
from dask_geomodeling_tpu_torch.geometry.base import BaseSingle, GeometryBlock

__all__ = ["ParseTextColumn"]

# grammar: a key is ASCII without '='; a value is any ASCII to line end
REGEX_KEYVALUE = re.compile(r"((?:[ -<>-~])+)=((?:[ -~])*)")

_LITERALS = {"null": None, "true": True, "false": False}
_MISSING = object()  # sentinel: key absent from the description


def autocast_value(value):
    """Cast a parsed string to string, float, bool or None."""
    if value is None:
        return None
    lowered = value.lower()
    if lowered in _LITERALS:
        return _LITERALS[lowered]
    try:
        return float(value)
    except ValueError:
        return value


def _parse_description(text, keys):
    """One description string -> {key: typed value} for the wanted keys."""
    if not isinstance(text, str):
        return {}
    found = dict(REGEX_KEYVALUE.findall(text))
    return {key: autocast_value(found[key]) for key in keys if key in found}


class ParseTextColumn(BaseSingle):
    """Parse a ``key=value`` text column into typed value columns.

    Args:
      source (GeometryBlock): data source
      source_column (str): existing text column
      key_mapping (dict): {key_name: output_column_name}
    """

    def __init__(self, source, source_column, key_mapping):
        expectations = ((source, GeometryBlock), (source_column, str), (key_mapping, dict))
        for value, expected in expectations:
            expect_instance(value, expected, "value")
        if source_column not in source.columns:
            raise KeyError("Column '{}' is not available.".format(source_column))
        super().__init__(source, source_column, key_mapping)

    source = arg(0)
    source_column = arg(1, "text column holding the key=value lines")
    key_mapping = arg(2, "{key: output column} selection")

    @property
    def columns(self):
        return self.source.columns | set(self.key_mapping.values())

    def get_sources_and_requests(self, **request):
        plan = {"source_column": self.source_column, "key_mapping": self.key_mapping}
        return [(self.source, request), (plan, None)]

    @staticmethod
    def process(data, plan):
        if "features" not in data or len(data["features"]) == 0:
            return data

        keys = list(plan["key_mapping"])
        out_names = list(plan["key_mapping"].values())
        features = data["features"].copy()
        texts = features[plan["source_column"]]

        # each distinct description parses once, however many rows share it
        cache = {}
        per_key_lookup = {key: {} for key in keys}
        for text in texts:
            if text in cache or (isinstance(text, float) and np.isnan(text)):
                continue
            cache[text] = parsed = _parse_description(text, keys)
            for key in keys:
                per_key_lookup[key][text] = parsed.get(key, _MISSING)

        for key, out_name in zip(keys, out_names):
            lookup = per_key_lookup[key]
            cells = [lookup.get(text, _MISSING) for text in texts]
            if all(cell is _MISSING or cell is None for cell in cells):
                features[out_name] = np.nan
            else:
                features[out_name] = Series(
                    [None if cell is _MISSING else cell for cell in cells], index=features.index
                )

        return {"features": features, "projection": data["projection"]}
