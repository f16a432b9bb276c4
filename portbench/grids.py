"""Regular latitude-longitude grids: cell centres, cell areas, and a land
and sea floor drawn as smooth blobs, not a scatter of cells. A product's
land mask and sea floor do not change with the data, so they are the same
in every run: drawn from a fixed stream, not from ``--seed``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.seeding import generator

#: Earth's radius of a sphere of equal volume, in metres
RADIUS_M = 6.371e6
#: the seeded field's knots (latitude, longitude): blobs of ~15 degrees
KNOTS = (12, 24)


def centres(nlat, nlon):
    """(lat, lon) of the cells' centres, in degrees, float64."""
    dlat, dlon = 180.0 / nlat, 360.0 / nlon
    return (-90.0 + dlat * (np.arange(nlat) + 0.5), dlon * (np.arange(nlon) + 0.5))


def areas(nlat, nlon):
    """The area of a cell in each row of latitude, in square metres (the
    sphere's band between the row's edges over one cell's longitudes)."""
    edges = np.deg2rad(np.linspace(-90.0, 90.0, nlat + 1))
    return RADIUS_M ** 2 * np.deg2rad(360.0 / nlon) * np.diff(np.sin(edges))


def ranks(nlat, nlon, device, name):
    """Each cell's place, 0 first, when the cells are ordered by a smooth
    field (bicubic between ``KNOTS`` normal values of the fixed stream
    ``name``), in latitude-major order: the first n cells by rank make
    blobs, so a threshold on the rank gives contiguous continents and basins
    with exactly n cells."""
    knots = torch.randn((1, 1, *KNOTS), generator=generator(device, "geography", name),
                        device=device)
    field = F.interpolate(knots, size=(nlat, nlon), mode="bicubic", align_corners=False)
    order = torch.argsort(field.reshape(-1), descending=True, stable=True)
    out = torch.empty_like(order)
    out[order] = torch.arange(order.numel(), device=device)
    return out
