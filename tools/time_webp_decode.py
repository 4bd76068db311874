"""Time the port's native WebP decoder on chip_smoke's lossy chunks.

Decodes each 512^2 chunk of tests/data/torch_webp/ortho-lossy (Pillow's
lossy WebP at GDAL's defaults, quality 75, method 4) ``--repeat`` times
with ``native.webp_decode_native`` and, where Pillow is installed, with
Pillow (libwebp), on one thread, and prints the mean milliseconds of a
decode and the MB/s of decoded RGB(A) for each.  A host measurement: it
says nothing of the card.

    python tools/time_webp_decode.py [--repeat 20]
"""
import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from dask_geomodeling_tpu_torch import native  # noqa: E402


def mean_seconds(decode, blob, repeat):
    decode(blob)  # warm: the library built and loaded
    t0 = time.perf_counter()
    for _ in range(repeat):
        decode(blob)
    return (time.perf_counter() - t0) / repeat


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeat", type=int, default=20)
    args = parser.parse_args()
    try:
        from PIL import Image

        def pillow(blob):
            with Image.open(io.BytesIO(blob)) as image:
                return np.asarray(image)
    except ImportError:
        pillow = None
    folder = os.path.join(chip_smoke.webp_fixture_hashes()[0], chip_smoke.ORTHO_LOSSY_DIR)
    for name in sorted(chip_smoke.ORTHO_LOSSY_CHUNKS):
        with open(os.path.join(folder, name), "rb") as f:
            blob = f.read()
        mb = native.webp_decode_native(blob).nbytes / 1e6
        ours = mean_seconds(native.webp_decode_native, blob, args.repeat)
        line = "%s (%d bytes): native %.2f ms (%.1f MB/s)" % (name, len(blob), ours * 1e3,
                                                              mb / ours)
        if pillow is not None:
            theirs = mean_seconds(pillow, blob, args.repeat)
            line += ", Pillow %.2f ms (%.1f MB/s)" % (theirs * 1e3, mb / theirs)
        print(line)


if __name__ == "__main__":
    main()
