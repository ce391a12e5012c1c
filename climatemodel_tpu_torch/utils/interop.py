"""Carry state and forcing across from NumPy arrays.

Each function here takes a mapping of NumPy arrays keyed by the JAX package's
field names (``ColumnState``, ``TimeStepInfo``, ``GreyForcing``, ``SWState``,
``SWParams``, ``BandArrays``, ``TransmissionCache``), plus a device (the card
unless the caller names another) and a float dtype, and returns the port's
dataclass.  For the column structs an
unbatched single-column mapping (``T`` of shape [nz-1, ny]) gets a batch
axis of one, so a JAX ``GreyGas.state`` pulled with ``jax.device_get`` and
turned into a dict feeds the port directly.  Integer fields become int32,
mask fields bool, every other field the given float dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.column import ColumnState, TimeStepInfo
from ..models.grey import GreyForcing
from ..models.real_gas import BandArrays, TransmissionCache
from ..models.shallow_water import SWParams, SWState

_INT_FIELDS = ('max_tend_ind', 'n_same_1', 'n_same_2')
_BOOL_FIELDS = ('removed', 'convective')


def _as_mapping(x):
    return x if isinstance(x, dict) else dataclasses.asdict(x)


def _convert(name, value, device, dtype, add_batch):
    a = np.asarray(value)
    if add_batch:
        a = a[None]
    if name in _INT_FIELDS:
        a = a.astype(np.int32)
    elif name in _BOOL_FIELDS:
        a = a.astype(bool)
    else:
        return torch.tensor(a, device=device).to(dtype)
    return torch.tensor(a, device=device)


def time_step_info_from_numpy(d, device='cuda', dtype=torch.float32,
                              add_batch=None) -> TimeStepInfo:
    """:class:`TimeStepInfo` from a mapping of NumPy arrays.  ``add_batch``
    defaults to "the mapping is a single column" (0-d ``delta_t``)."""
    d = _as_mapping(d)
    if add_batch is None:
        add_batch = np.ndim(d['delta_t']) == 0
    return TimeStepInfo(**{f.name: _convert(f.name, d[f.name], device, dtype,
                                            add_batch)
                           for f in dataclasses.fields(TimeStepInfo)})


def column_state_from_numpy(d, device='cuda', dtype=torch.float32) -> ColumnState:
    """:class:`ColumnState` from a mapping with ``T``, ``net_flux``, ``t``
    and ``tsi`` (itself a mapping or dataclass of arrays)."""
    d = _as_mapping(d)
    add_batch = np.ndim(d['T']) == 2
    conv = lambda k: _convert(k, d[k], device, dtype, add_batch)  # noqa: E731
    return ColumnState(T=conv('T'), net_flux=conv('net_flux'), t=conv('t'),
                       tsi=time_step_info_from_numpy(d['tsi'], device, dtype,
                                                     add_batch))


def grey_forcing_from_numpy(d, device='cuda', dtype=torch.float32) -> GreyForcing:
    """:class:`GreyForcing` from a mapping with the JAX field names."""
    d = _as_mapping(d)
    add_batch = np.ndim(d['dtau']) == 2
    return GreyForcing(**{f.name: _convert(f.name, d[f.name], device, dtype,
                                           add_batch)
                          for f in dataclasses.fields(GreyForcing)})


def sw_state_from_numpy(d, device='cuda', dtype=torch.float32) -> SWState:
    """:class:`SWState` from a mapping (or dataclass) of the JAX ``SWState``
    fields: h, u, v [nx, ny], 0-d t and dt in ``dtype``, 0-d bool ok."""
    d = _as_mapping(d)
    fields = {k: torch.tensor(np.asarray(d[k]), device=device).to(dtype)
              for k in ('h', 'u', 'v', 't', 'dt')}
    return SWState(ok=torch.tensor(bool(np.asarray(d['ok'])), device=device),
                   **fields)


def sw_params_from_numpy(d, device='cuda', dtype=torch.float32) -> SWParams:
    """:class:`SWParams` from a mapping (or dataclass) of the JAX
    ``SWParams`` fields, every one in ``dtype`` (the masks too, as in the
    JAX package)."""
    d = _as_mapping(d)
    return SWParams(**{f.name: torch.tensor(np.asarray(d[f.name]),
                                            device=device).to(dtype)
                       for f in dataclasses.fields(SWParams)})


_INDEX_FIELDS = ('idx', 'lw_idx', 'lw_list')


def band_arrays_from_numpy(d, device='cuda', dtype=torch.float32) -> BandArrays:
    """:class:`~climatemodel_tpu_torch.models.real_gas.BandArrays` from a
    mapping with the JAX field names: the index fields int64, the others
    ``dtype``."""
    d = _as_mapping(d)
    out = {}
    for f in dataclasses.fields(BandArrays):
        a = np.asarray(d[f.name])
        out[f.name] = (torch.tensor(a.astype(np.int64), device=device)
                       if f.name in _INDEX_FIELDS else
                       torch.tensor(a, device=device).to(dtype))
    return BandArrays(**out)


def transmission_cache_from_numpy(d, device='cuda', dtype=torch.float32
                                  ) -> TransmissionCache:
    """:class:`~climatemodel_tpu_torch.models.real_gas.TransmissionCache`
    from a mapping with the JAX field names.  A bfloat16 field (the reduced
    layout's operators) stays bfloat16; a None field stays None; every other
    field becomes ``dtype``."""
    d = _as_mapping(d)
    out = {}
    for f in dataclasses.fields(TransmissionCache):
        v = d.get(f.name)
        if v is None:
            out[f.name] = None
            continue
        a = np.asarray(v)
        if a.dtype.name == 'bfloat16':
            out[f.name] = torch.tensor(a.astype(np.float32),
                                       device=device).to(torch.bfloat16)
        else:
            out[f.name] = torch.tensor(a, device=device).to(dtype)
    return TransmissionCache(**out)
