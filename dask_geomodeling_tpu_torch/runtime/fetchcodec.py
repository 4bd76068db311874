"""Packed fetch encode on the device, batch-first.

Counterpart of dask_geomodeling_tpu/runtime/fetchcodec.py:FetchCodec.encode.
The codec itself is the JAX package's: ``derive_codec`` chooses it and
``FetchCodec.decode`` unpacks on the host.  Only the encode runs here,
over (B, bands, h, w) at once.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.device import equal_scalar, torch_dtype

__all__ = ["encode_torch"]


def encode_torch(codec, values):
    """(B, bands, h, w) tensor -> (B, bands, ceil(h*w/G)) codes, the wire
    format ``codec.decode`` reverses."""
    n_batch, bands = values.shape[:2]
    flat = values.reshape(n_batch, bands, -1)
    if codec.palette is not None:
        palette = torch.from_numpy(codec.palette).to(values.device)
        codes = torch.searchsorted(
            palette, flat.to(palette.dtype).contiguous()
        ).to(torch.int32)
    else:
        codes = flat.to(torch.int32) - codec.lo
    if codec.fill_code is not None:
        if isinstance(codec.fill, float) and np.isnan(codec.fill):
            is_fill = torch.isnan(flat)
        else:
            is_fill = equal_scalar(flat, codec.fill)
        codes = torch.where(is_fill, codec.fill_code, codes)
    if codec.group == 1:
        return codes.to(torch_dtype(codec.code_dtype))
    pad = (-codes.shape[-1]) % codec.group
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    groups = codes.reshape(n_batch, bands, -1, codec.group)
    weights = torch.tensor(
        [codec.symbols ** (codec.group - 1 - k) for k in range(codec.group)],
        dtype=torch.int32,
        device=values.device,
    )
    packed = (groups * weights).sum(dim=-1, dtype=torch.int32)
    return packed.to(torch_dtype(codec.code_dtype))
