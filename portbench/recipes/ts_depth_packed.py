"""CF-packed int16 temperature and salinity on (month, depth, cell) grids,
as a product's files store them, with the wet cells' volume.

The ``ts_depth`` recipe's laws, land share and sea floor, at the
configuration's level depths ``depth_m``: each layer reaches from the
midpoint between its depth and the one above (the surface for the first)
to the midpoint with the one below, the last as far below its depth as its
top lies above it; a level's depth in the laws and the sea-floor test is
its layer's middle, as in ``ts_depth``. The cells are a regular grid of
``nlat`` latitudes, cell centres from ``lat_deg[0]`` to ``lat_deg[1]``
(each cell half a step either side, clipped at the poles), by ``nlon``
longitudes, latitude-major.

Each month of T and S is drawn in float32 from the seed and packed into the
int16 field as the product stores it: ``round((x - add_offset) /
scale_factor)`` clamped to ``valid_range``, and ``fill_value`` in dry cells
(land and below the sea floor). So the float32 of the whole record never
exists: set-up holds the packed fields and one month of float32. The edges
are the configuration's, in degrees C and psu, expressed in packed units as
float64, ``(e - add_offset) / scale_factor``. The volume is the cell's area
times the layer's thickness in a wet cell, 0 in a dry one, (level, cell),
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import grids
from portbench.recipes import ts_depth
from portbench.seeding import generator


def thicknesses(depth_m):
    """Each layer's thickness, in metres, float64: the differences of the
    midpoints between ``depth_m``, from 0 m at the top, the bottom as far
    below the last depth as the last layer's top lies above it."""
    d = np.asarray(depth_m, np.float64)
    mid = (d[1:] + d[:-1]) / 2
    return np.diff(np.concatenate([[0.0], mid, [2 * d[-1] - mid[-1]]]))


def areas(lat_deg, nlat, nlon):
    """The area of a cell in each row of latitude, in square metres: rows
    centred from ``lat_deg[0]`` to ``lat_deg[1]``, each half a step either
    side, clipped at the poles."""
    lat = np.linspace(lat_deg[0], lat_deg[1], nlat)
    half = (lat[-1] - lat[0]) / (nlat - 1) / 2
    edges = np.concatenate([[lat[0] - half], (lat[1:] + lat[:-1]) / 2, [lat[-1] + half]])
    edges = np.deg2rad(np.clip(edges, -90.0, 90.0))
    return grids.RADIUS_M ** 2 * np.deg2rad(360.0 / nlon) * np.diff(np.sin(edges))


def packed_edges(spec, packing):
    """The edges of ``spec`` (as ``ts_depth.edges`` makes them) in packed
    units, float64."""
    e = ts_depth.edges(spec).astype(np.float64)
    return (e - packing["add_offset"]) / packing["scale_factor"]


def pack_(x, packing, lo, hi):
    """``x`` (float32, in place) as packed integers: ``round((x -
    add_offset) / scale_factor)`` clamped to [lo, hi]."""
    return x.sub_(packing["add_offset"]).div_(packing["scale_factor"]).round_().clamp_(lo, hi)


def make(config, seed, device, fields):
    dz = thicknesses(config["depth_m"])
    layered = {**config, "drF_m": dz.tolist()}
    z, _ = ts_depth.depths(layered)
    nlat, nlon = config["nlat"], config["nlon"]
    cells = nlat * nlon
    shape = (config["months"], len(dz), cells)
    pk = config["packing"]
    lo, hi = pk["valid_range"]
    out = {name: packed_edges(config[name], pk[name[0]]) for name in ("T_edges", "S_edges")}
    wet = None
    if any(name in ts_depth.LAWS or name == "volume" for name in fields):
        rank = grids.ranks(nlat, nlon, device, "sea floor")
        counts = torch.as_tensor(ts_depth.wet_counts(layered), device=device)
        wet = rank[None, :] < counts[:, None]  # (level, cell): the deepest floors first
    for name in fields:
        if name in ts_depth.LAWS:
            m0, m1, s0, s1, scale = ts_depth.LAWS[name]
            decay = np.exp(-z / scale)
            mean = torch.tensor(m0 + m1 * decay, dtype=torch.float32, device=device)
            sd = torch.tensor(s0 + s1 * decay, dtype=torch.float32, device=device)
            x = torch.empty(shape, dtype=torch.int16, device=device)
            month = torch.empty(shape[1:], dtype=torch.float32, device=device)
            g = generator(device, seed, name)
            for k in range(shape[0]):
                month.normal_(generator=g)
                month.mul_(sd[:, None]).add_(mean[:, None])
                x[k].copy_(pack_(month, pk[name], lo, hi)).masked_fill_(~wet, pk["fill_value"])
            out[name] = x
        elif name == "volume":
            area = np.repeat(areas(config["lat_deg"], nlat, nlon), nlon)
            vol = torch.tensor(dz[:, None] * area[None, :], dtype=torch.float32, device=device)
            out[name] = vol.masked_fill_(~wet, 0.0)
        elif name not in out:
            raise KeyError(f"the ts_depth_packed recipe makes no field {name!r}")
    return out
