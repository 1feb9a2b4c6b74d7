"""Carry a Space across between the JAX package and this port.

The JAX package's ``SpaceState`` and ``TickInputs`` lanes, as numpy
arrays keyed by lane name, become this port's tensors, and back. Two
lanes change representation on the way:

* ``attr_dirty``: JAX uint32, here the same bits in int32 (``.view``);
* ``rng``: the JAX uint32[2] key, here int64[2] holding the two words.

Random walk has no learned weights, so this converter is all that
carries a world across.

A megaspace's stacked state is the same ``SpaceState`` with a leading
``[n_dev]`` axis on every lane (``rng`` is then ``[n_dev, 2]`` and
``tick`` ``[n_dev]``): :func:`state_from_numpy` and
:func:`state_to_numpy` carry it as they are. :func:`multi_inputs_from_
numpy` and :func:`mega_outputs_to_numpy` carry its inputs and outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goworld_tpu_torch.core.state import SpaceState, resolve_device
from goworld_tpu_torch.core.step import TickInputs, TickOutputs
from goworld_tpu_torch.parallel.megaspace import MegaTickOutputs
from goworld_tpu_torch.parallel.step import MultiTickInputs

_ABSENT_OK = ("aoi_cache", "behavior_id")


def state_from_numpy(arrays: dict, device="cuda") -> SpaceState:
    """A ``SpaceState`` on ``device`` from numpy lanes keyed by name.
    The JAX-only lanes ``aoi_cache`` and ``behavior_id`` must be absent
    or None (their configs are not ported)."""
    dev = resolve_device(device)
    for name in _ABSENT_OK:
        if arrays.get(name) is not None:
            raise NotImplementedError(
                f"lane {name!r} is not ported (see ROADMAP.md Queue A)")
    lanes = {}
    for f in dataclasses.fields(SpaceState):
        a = np.asarray(arrays[f.name])
        if f.name == "attr_dirty":
            a = a.astype(np.uint32).view(np.int32)
        elif f.name == "rng":
            a = a.astype(np.uint32).astype(np.int64)
        lanes[f.name] = torch.tensor(a, device=dev)
    return SpaceState(**lanes)


def state_to_numpy(state: SpaceState) -> dict:
    """The lanes of ``state`` as numpy arrays in the JAX package's
    types."""
    out = {}
    for f in dataclasses.fields(SpaceState):
        a = getattr(state, f.name).detach().cpu().numpy()
        if f.name == "attr_dirty":
            a = a.view(np.uint32)
        elif f.name == "rng":
            a = a.astype(np.uint32)
        out[f.name] = a
    return out


def inputs_from_numpy(arrays: dict, device="cuda") -> TickInputs:
    """``TickInputs`` on ``device`` from numpy lanes keyed by name."""
    dev = resolve_device(device)
    return TickInputs(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=dev)
        for f in dataclasses.fields(TickInputs)
    })


def outputs_to_numpy(outputs: TickOutputs) -> dict:
    """The lanes of ``outputs`` as numpy arrays (lanes that are None,
    as the megaspace's skin telemetry, are left out)."""
    return {f.name: getattr(outputs, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(TickOutputs)
            if getattr(outputs, f.name) is not None}


def multi_inputs_from_numpy(arrays: dict, device="cuda") -> MultiTickInputs:
    """``MultiTickInputs`` on ``device`` from numpy lanes: ``arrays``
    holds ``base`` (the ``TickInputs`` lanes with a leading [n_dev]
    axis), ``migrate_target`` and ``migrate_tag``."""
    dev = resolve_device(device)
    return MultiTickInputs(
        base=inputs_from_numpy(arrays["base"], device=dev),
        migrate_target=torch.tensor(np.asarray(arrays["migrate_target"]),
                                    device=dev),
        migrate_tag=torch.tensor(np.asarray(arrays["migrate_tag"]),
                                 device=dev),
    )


def mega_outputs_to_numpy(outputs: MegaTickOutputs) -> dict:
    """The lanes of megaspace ``outputs`` as numpy arrays; ``base`` is
    the dict of :func:`outputs_to_numpy`."""
    out = {f.name: getattr(outputs, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(MegaTickOutputs) if f.name != "base"}
    out["base"] = outputs_to_numpy(outputs.base)
    return out
