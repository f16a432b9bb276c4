"""Daily sea-surface temperature on a regular latitude-longitude grid.

Over the ocean, on day d at latitude phi,

    SST = max(-1.8, 28 - 30 sin^2(phi) + 3 sin(phi) sin(2 pi d / 365) + N(0, 0.6^2))

in deg C. ``land_fraction`` of the cells, smooth blobs the same in every
run (``grids.ranks``), are land: NaN every day. The coordinates are the cells'
centres.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import grids
from portbench.seeding import generator


def coords(config):
    lat, lon = grids.centres(config["nlat"], config["nlon"])
    return {"lat": lat, "lon": lon}


def make(config, seed, device, fields):
    days, nlat, nlon = config["days"], config["nlat"], config["nlon"]
    spec = config["sst_edges"]
    out = {"sst_edges": np.linspace(spec["lo"], spec["hi"], spec["n"]).astype(spec["dtype"]),
           **coords(config)}
    if "sst" not in fields:
        return out
    phi = torch.tensor(np.deg2rad(out["lat"]), dtype=torch.float32, device=device)
    season = torch.sin(2 * np.pi * torch.arange(days, device=device, dtype=torch.float32) / 365)
    x = torch.empty((days, nlat, nlon), dtype=torch.float32, device=device)
    x.normal_(0.0, 0.6, generator=generator(device, seed, "sst"))
    x.add_((28 - 30 * phi.sin() ** 2)[None, :, None])
    x.add_((3 * phi.sin())[None, :, None] * season[:, None, None])
    x.clamp_min_(-1.8)
    cells = nlat * nlon
    land = grids.ranks(nlat, nlon, device, "land") < round(config["land_fraction"] * cells)
    out["sst"] = x.masked_fill_(land.reshape(1, nlat, nlon), float("nan"))
    return out
