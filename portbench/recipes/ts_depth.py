"""Temperature and salinity on (time, depth, cell) grids, with the wet
cells' volume.

The levels are the configuration's layer thicknesses ``drF_m``, each
level's depth the middle of its layer. The cells are a regular
latitude-longitude grid, latitude-major. ``land_share`` of the cells are
land, and the rest have a sea floor whose depths follow the configuration's
``hypsometry`` (shares of the ocean's area in depth bands, uniform within a
band): a cell is wet at a level whose depth lies above its floor. Land and
floor are smooth blobs, the same in every run (``grids.ranks``); T and S
are drawn from the seed. At depth z, in a wet cell,

    T ~ N(2 + 24 exp(-z / 600 m), 0.5 + 7 exp(-z / 600 m))   (deg C)
    S ~ N(34.7 + 0.6 exp(-z / 400 m), 0.1 + 1.4 exp(-z / 400 m))   (psu)

so deep levels pile into few bins, as in a real ocean; T and S are NaN in
a dry cell, as in the product's files. The volume is the cell's area times
the layer's thickness in a wet cell, 0 in a dry one, (level, cell), float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import grids
from portbench.seeding import generator

LAWS = {"T": (2.0, 24.0, 0.5, 7.0, 600.0), "S": (34.7, 0.6, 0.1, 1.4, 400.0)}


def depths(config):
    """(depth of each level's middle, thickness), in metres, float64."""
    dz = np.asarray(config["drF_m"], np.float64)
    return np.cumsum(dz) - dz / 2, dz


def edges(spec):
    return np.linspace(spec["lo"], spec["hi"], spec["n"]).astype(spec.get("dtype", "float32"))


def wet_counts(config):
    """Wet cells at each level: the ocean's cells whose floor lies below the
    level's depth, by the hypsometry."""
    z, _ = depths(config)
    cells = config["nlat"] * config["nlon"]
    ocean = round(cells * (1.0 - config["land_share"]))
    h = config["hypsometry"]
    cdf = np.concatenate([[0.0], np.cumsum(h["share_pct"])])
    cdf /= cdf[-1]
    shallower = np.interp(z, np.asarray(h["depth_m"], np.float64), cdf)
    return np.rint(ocean * (1.0 - shallower)).astype(np.int64)


def make(config, seed, device, fields):
    z, dz = depths(config)
    levels, nlat, nlon = len(dz), config["nlat"], config["nlon"]
    if config.get("levels", levels) != levels:
        raise ValueError(f"{levels} layer thicknesses for {config['levels']} levels")
    shape = (config["times"], levels, nlat * nlon)
    out = {"T_edges": edges(config["T_edges"]), "S_edges": edges(config["S_edges"])}
    wet = None
    if any(name in LAWS or name == "volume" for name in fields):
        rank = grids.ranks(nlat, nlon, device, "sea floor")
        counts = torch.as_tensor(wet_counts(config), device=device)
        wet = rank[None, :] < counts[:, None]  # (level, cell): the deepest floors first
    for name in fields:
        if name in LAWS:
            m0, m1, s0, s1, scale = LAWS[name]
            decay = np.exp(-z / scale)
            mean = torch.tensor(m0 + m1 * decay, dtype=torch.float32, device=device)
            sd = torch.tensor(s0 + s1 * decay, dtype=torch.float32, device=device)
            x = torch.empty(shape, dtype=torch.float32, device=device)
            x.normal_(generator=generator(device, seed, name))
            x.mul_(sd[:, None]).add_(mean[:, None])
            out[name] = x.masked_fill_(~wet, float("nan"))
        elif name == "volume":
            area = np.repeat(grids.areas(nlat, nlon), nlon)
            vol = torch.tensor(dz[:, None] * area[None, :], dtype=torch.float32, device=device)
            out[name] = vol.masked_fill_(~wet, 0.0)
        elif name not in out:
            raise KeyError(f"the ts_depth recipe makes no field {name!r}")
    return out
