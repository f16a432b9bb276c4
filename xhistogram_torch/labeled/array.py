"""A minimal labeled array: named dims and coordinates over a torch tensor.

Counterpart of ``xhistogram_tpu.labeled.array``. The reference's labeled
layer delegates to xarray (reference xarray.py); this one is
self-contained: a small ``NamedArray`` carrying ``dims``/``coords``/
``attrs``/``name`` around a ``torch.Tensor``, with exactly the surface the
histogram wrapper and its tests need (the subset of the xr.DataArray API
the reference touches at xarray.py:109-199): ``get_axis_num``,
``expand_dims``, ``transpose``, ``reset_coords``, ``sum``, ``isel``, coords
with attrs. ``data`` is a tensor, kept on whatever device it lies on
(numpy data becomes a CPU tensor sharing its memory); coordinates hold
numpy data, since they are labels.

``labeled.api.histogram`` duck-types on this surface, so a real
``xarray.DataArray`` works too when xarray is installed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NamedArray", "full_like"]


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if any(s < 0 for s in x.strides):
        x = x.copy()  # torch views no negative strides
    return torch.as_tensor(x)


def _values(x):
    """numpy view of a tensor (bfloat16, which numpy lacks, as float32) or
    of any array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class NamedArray:
    """N-D tensor with named dimensions, coordinates, attrs, and a name.

    coords maps a coordinate name to a ``NamedArray`` whose dims are a subset
    of this array's dims (dimension coordinates have ``coord.dims ==
    (coord_name,)``); a coordinate's data stays numpy.
    """

    __slots__ = ("data", "dims", "coords", "name", "attrs")

    def __init__(self, data, dims, coords=None, name=None, attrs=None,
                 _label=False):
        self.data = np.asarray(data) if _label else _as_tensor(data)
        dims = tuple(dims)
        if len(dims) != self.data.ndim:
            raise ValueError(
                f"{len(dims)} dims given for data of rank {self.data.ndim}"
            )
        self.dims = dims
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.coords = {}
        if coords:
            for cname, cval in coords.items():
                self.coords[cname] = self._coerce_coord(cname, cval)

    @staticmethod
    def _label(cdata, cdims, cname, cattrs=None):
        return NamedArray(_values(cdata), cdims, name=cname, attrs=cattrs,
                          _label=True)

    def _coerce_coord(self, cname, cval):
        if isinstance(cval, NamedArray):
            coord = cval
            if not isinstance(coord.data, np.ndarray):  # labels stay numpy
                coord = NamedArray(_values(coord.data), coord.dims, name=coord.name,
                                   attrs=coord.attrs, _label=True)
        elif isinstance(cval, tuple) and len(cval) in (2, 3):
            cdims, cdata = cval[0], cval[1]
            cattrs = cval[2] if len(cval) == 3 else None
            if isinstance(cdims, str):
                cdims = (cdims,)
            coord = self._label(cdata, cdims, cname, cattrs)
        elif hasattr(cval, "dims") and hasattr(cval, "data"):
            # duck labeled coord (e.g. an xarray coordinate DataArray):
            # keep its own dims/attrs — may span several of this array's dims
            coord = self._label(cval.data, tuple(cval.dims), cname,
                                dict(getattr(cval, "attrs", {}) or {}))
        else:
            coord = self._label(cval, (cname,), cname)
        for d in coord.dims:
            if d not in self.dims:
                raise ValueError(
                    f"coordinate {cname!r} has dim {d!r} not present in {self.dims}"
                )
        return coord

    # -- basic introspection ------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        return _values(self.data)

    def get_axis_num(self, dim):
        return self.dims.index(dim)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[key]
        raise TypeError("positional indexing not supported; use .isel()")

    def __repr__(self):
        coord_names = ", ".join(self.coords)
        return (
            f"<NamedArray {self.name!r} {dict(zip(self.dims, self.shape))} "
            f"coords=[{coord_names}]>"
        )

    # -- transforms (all return new NamedArrays) ----------------------------
    def _replace(self, data=None, dims=None, coords=None, name="__keep__", attrs=None):
        return NamedArray(
            self.data if data is None else data,
            self.dims if dims is None else dims,
            coords=self.coords if coords is None else coords,
            name=self.name if name == "__keep__" else name,
            attrs=self.attrs if attrs is None else attrs,
            _label=isinstance(self.data, np.ndarray),
        )

    def rename(self, name):
        return self._replace(name=name)

    def reset_coords(self, drop=False):
        """Drop non-dimension coordinates (reference xarray.py:120-121 uses
        drop=True to simplify alignment)."""
        if not drop:
            raise NotImplementedError("only reset_coords(drop=True) is supported")
        keep = {k: v for k, v in self.coords.items() if k in self.dims}
        return self._replace(coords=keep)

    def expand_dims(self, sizes):
        """Prepend new length-``n`` dims, given ``{name: n}``
        (reference xarray.py:140); a view of the data."""
        new_dims = tuple(sizes.keys()) + self.dims
        shape = tuple(sizes.values()) + self.shape
        data = self.data.reshape((1,) * len(sizes) + self.shape)
        if any(n != 1 for n in sizes.values()):
            data = (np.broadcast_to(data, shape) if isinstance(data, np.ndarray)
                    else data.expand(shape))
        return self._replace(data=data, dims=new_dims)

    def transpose(self, *dims):
        if set(dims) != set(self.dims):
            raise ValueError(f"transpose dims {dims} != array dims {self.dims}")
        perm = [self.dims.index(d) for d in dims]
        data = (self.data.transpose(perm) if isinstance(self.data, np.ndarray)
                else self.data.permute(perm))
        return self._replace(data=data, dims=dims)

    def isel(self, indexers=None, **kw):
        indexers = dict(indexers or {}, **kw)
        idx = tuple(
            indexers.get(d, slice(None)) for d in self.dims
        )
        new_dims = tuple(
            d for d in self.dims if not isinstance(indexers.get(d), int)
        )
        coords = {}
        for cname, c in self.coords.items():
            if all(not isinstance(indexers.get(d), int) for d in c.dims):
                cidx = tuple(indexers.get(d, slice(None)) for d in c.dims)
                coords[cname] = self._label(c.data[cidx], c.dims, cname, c.attrs)
        return NamedArray(
            self.data[idx], new_dims, coords=coords, name=self.name,
            attrs=self.attrs, _label=isinstance(self.data, np.ndarray),
        )

    def sum(self, dim=None):
        if dim is None:
            dims = self.dims
        elif isinstance(dim, str):
            dims = (dim,)
        else:
            dims = tuple(dim)
        if not dims:
            return self
        axes = tuple(self.dims.index(d) for d in dims)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {
            k: v
            for k, v in self.coords.items()
            if all(cd in new_dims for cd in v.dims)
        }
        data = (self.data.sum(axis=axes) if isinstance(self.data, np.ndarray)
                else self.data.sum(dim=axes))
        return NamedArray(data, new_dims, coords=coords, name=self.name,
                          attrs=self.attrs, _label=isinstance(data, np.ndarray))

    # -- comparison helpers (test support) -----------------------------------
    def equals(self, other):
        if self.dims != tuple(other.dims):
            return False
        if not np.array_equal(self.values, np.asarray(other.values)):
            return False
        if set(self.coords) != set(other.coords):
            return False
        return all(
            np.array_equal(self.coords[k].values, np.asarray(other.coords[k].values))
            and self.coords[k].dims == tuple(other.coords[k].dims)
            for k in self.coords
        )

    def identical(self, other):
        return self.equals(other) and self.name == other.name


def full_like(template: NamedArray, fill_value, name=None) -> NamedArray:
    """A NamedArray shaped, typed, placed and labeled like ``template``,
    filled with ``fill_value``."""
    return NamedArray(
        torch.full_like(_as_tensor(template.data), fill_value),
        template.dims,
        coords=template.coords,
        name=name if name is not None else template.name,
        attrs=template.attrs,
    )
