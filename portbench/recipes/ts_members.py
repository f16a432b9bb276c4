"""Surface temperature and salinity of an ensemble's members, member axis
outermost: (member, month, lat, lon) float32.

Each ocean cell has a mean state, the same in every member and month: T
from the ``sst_daily`` recipe's latitude profile, ``max(-1.8, 28 - 30
sin^2(lat))`` deg C, and S drawn once per cell from the ``ts_depth``
recipe's S law at the configuration's ``surface_depth_m``. Each member adds
its own anomaly to each cell and month, N(0, ``anomaly_sd["T"]^2``) and
N(0, ``anomaly_sd["S"]^2``): a row's members then share a handful of
slots, as an ensemble's members do. ``land_share`` of the cells, smooth
blobs the same in every run (``grids.ranks``), are land: NaN in every
member and month. Each field is filled in place, so set-up holds the two
fields and a cell's worth of means.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import grids
from portbench.recipes import ts_depth
from portbench.seeding import generator


def _means(config, seed, device):
    """The cells' mean T and S, (lat, lon) float32."""
    nlat, nlon = config["nlat"], config["nlon"]
    lat, _ = grids.centres(nlat, nlon)
    phi = torch.tensor(np.deg2rad(lat), dtype=torch.float32, device=device)
    t = (28 - 30 * phi.sin() ** 2).clamp_min(-1.8)[:, None].expand(nlat, nlon)
    m0, m1, s0, s1, scale = ts_depth.LAWS["S"]
    decay = np.exp(-config["surface_depth_m"] / scale)
    s = torch.empty((nlat, nlon), dtype=torch.float32, device=device)
    s.normal_(m0 + m1 * decay, s0 + s1 * decay, generator=generator(device, seed, "S mean"))
    return {"T": t, "S": s}


def make(config, seed, device, fields):
    out = {"T_edges": ts_depth.edges(config["T_edges"]),
           "S_edges": ts_depth.edges(config["S_edges"])}
    wanted = [name for name in fields if name not in out]
    unknown = set(wanted) - {"T", "S"}
    if unknown:
        raise KeyError(f"the ts_members recipe makes no field {sorted(unknown)!r}")
    if not wanted:
        return out
    nlat, nlon = config["nlat"], config["nlon"]
    shape = (config["members"], config["months"], nlat, nlon)
    land = grids.ranks(nlat, nlon, device, "land") < round(config["land_share"] * nlat * nlon)
    means = _means(config, seed, device)
    for name in wanted:
        x = torch.empty(shape, dtype=torch.float32, device=device)
        x.normal_(0.0, config["anomaly_sd"][name], generator=generator(device, seed, name))
        x.add_(means[name])
        out[name] = x.masked_fill_(land.reshape(nlat, nlon), float("nan"))
    return out
