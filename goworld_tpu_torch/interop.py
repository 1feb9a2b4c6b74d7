"""Carry a Space across between the JAX package and this port.

The JAX package's ``SpaceState`` and ``TickInputs`` lanes, as numpy
arrays keyed by lane name, become this port's tensors, and back. Some
lanes change representation on the way:

* ``attr_dirty``: JAX uint32, here the same bits in int32 (``.view``);
* ``rng``: the JAX uint32[2] key, here int64[2] holding the two words;
* ``vel`` under precision=q16: bfloat16 on both sides, carried through
  its 16-bit pattern (numpy's ``bfloat16`` is ``ml_dtypes``', imported
  only to hand such a lane back);
* ``aoi_cache`` (the Verlet cache, a dict of numpy lanes keyed by the
  ``VerletCache`` field names, or the JAX cache itself): its ``cand``
  words under precision=q16 are JAX uint32, here int32 bits. A state
  whose ``vel`` lane is bfloat16 is a q16 state.

A scenario world's ``behavior_id`` lane (int32, or absent/None without
a scenario) crosses as it is. The mlp behavior's weights cross by
:func:`policy_from_numpy` and :func:`policy_to_numpy` (bf16 lanes as
``ml_dtypes`` arrays or their uint16 words).

Several Spaces (the World's stacked state at ``n_spaces > 1``, the JAX
package's vmapped step) and a megaspace's tiles are the same
``SpaceState`` with a leading ``[S]`` axis on every lane (``rng`` is
then ``[S, 2]`` and ``tick`` ``[S]``): :func:`state_from_numpy` and
:func:`state_to_numpy` carry it as they are, and so do the inputs
(:func:`inputs_from_numpy`, :func:`inputs_to_numpy`) and outputs
(:func:`outputs_from_numpy`, :func:`outputs_to_numpy`), both ways.
:func:`multi_inputs_from_numpy` and :func:`mega_outputs_to_numpy` carry
a megaspace's inputs and outputs, and a multi-space step's
(``parallel.step.make_multi_tick``). A JAX World on
a mesh or a megaspace World keeps the same stacked lanes: gathered to
numpy (``np.asarray`` of each lane), they cross by
:func:`state_from_numpy` as they are.

One controller of a game of several
(:mod:`goworld_tpu_torch.parallel.multihost`) holds its own shards of
such a global stacked state: :func:`local_shards` cuts the numpy lanes
of a state, its inputs or a cache to them (``mesh.local_shards``), and
they cross as above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from goworld_tpu_torch.core.state import SpaceState, resolve_device
from goworld_tpu_torch.ops.aoi import VerletCache
from goworld_tpu_torch.core.step import TickInputs, TickOutputs
from goworld_tpu_torch.models.npc_policy import MLPPolicy
from goworld_tpu_torch.parallel.megaspace import MegaTickOutputs
from goworld_tpu_torch.parallel.step import (
    MultiTickInputs,
    MultiTickOutputs,
)

_OPTIONAL = ("aoi_cache", "behavior_id")
_POLICY_LANES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=dev) \
            .view(torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=dev)


def _cache_from(cache, dev) -> VerletCache | None:
    if cache is None:
        return None
    get = cache.get if isinstance(cache, dict) \
        else lambda name: getattr(cache, name)
    return VerletCache(**{f.name: _tensor(np.asarray(get(f.name)), dev)
                          for f in dataclasses.fields(VerletCache)})


def local_shards(arrays: dict, shards: range) -> dict:
    """The numpy lanes of a global stacked state, its inputs or its
    outputs (nested dicts included; None kept) cut to ``shards`` on
    their leading axis: one controller's part."""
    return {k: local_shards(v, shards) if isinstance(v, dict)
            else None if v is None
            else np.asarray(v)[shards.start:shards.stop]
            for k, v in arrays.items()}


def state_from_numpy(arrays: dict, device="cuda") -> SpaceState:
    """A ``SpaceState`` on ``device`` from numpy lanes keyed by name
    (``aoi_cache`` and ``behavior_id`` may be absent or None)."""
    dev = resolve_device(device)
    lanes = {}
    for f in dataclasses.fields(SpaceState):
        if f.name == "aoi_cache":
            lanes[f.name] = _cache_from(arrays.get(f.name), dev)
            continue
        if f.name in _OPTIONAL and arrays.get(f.name) is None:
            lanes[f.name] = None
            continue
        a = np.asarray(arrays[f.name])
        if f.name == "attr_dirty":
            a = a.astype(np.uint32).view(np.int32)
        elif f.name == "rng":
            a = a.astype(np.uint32).astype(np.int64)
        lanes[f.name] = _tensor(a, dev)
    return SpaceState(**lanes)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).cpu().numpy().view(ml_dtypes.bfloat16)
    return t.cpu().numpy()


def state_to_numpy(state: SpaceState) -> dict:
    """The lanes of ``state`` as numpy arrays in the JAX package's
    types; ``aoi_cache`` as a dict of numpy lanes (left out when the
    state has none, as ``behavior_id`` is)."""
    out = {}
    q16 = state.vel.dtype == torch.bfloat16
    for f in dataclasses.fields(SpaceState):
        v = getattr(state, f.name)
        if f.name == "aoi_cache":
            if v is not None:
                cache = {c.name: _numpy(getattr(v, c.name))
                         for c in dataclasses.fields(VerletCache)}
                if q16:
                    cache["cand"] = cache["cand"].view(np.uint32)
                out[f.name] = cache
            continue
        if v is None:
            continue
        a = _numpy(v)
        if f.name == "attr_dirty":
            a = a.view(np.uint32)
        elif f.name == "rng":
            a = a.astype(np.uint32)
        out[f.name] = a
    return out


def policy_from_numpy(arrays, device="cuda") -> MLPPolicy:
    """An ``MLPPolicy`` on ``device`` from the JAX package's parameters:
    a dict (or an object with the attributes) of ``w1 b1 w2 b2 w3 b3``,
    each a bf16 array (``ml_dtypes``) or its uint16 words."""
    dev = resolve_device(device)
    get = arrays.get if isinstance(arrays, dict) \
        else lambda name: getattr(arrays, name)
    lanes = {}
    for name in _POLICY_LANES:
        a = np.asarray(get(name))
        if a.dtype.name != "bfloat16" and a.dtype != np.uint16:
            raise TypeError(f"{name}: expected bf16 or uint16 words, got "
                            f"{a.dtype}")
        lanes[name] = torch.tensor(a.view(np.int16), device=dev) \
            .view(torch.bfloat16)
    return MLPPolicy(**lanes)


def policy_to_numpy(policy: MLPPolicy) -> dict:
    """The policy's lanes as ``ml_dtypes`` bf16 arrays keyed by name."""
    return {name: _numpy(getattr(policy, name)) for name in _POLICY_LANES}


def inputs_from_numpy(arrays: dict, device="cuda") -> TickInputs:
    """``TickInputs`` on ``device`` from numpy lanes keyed by name."""
    dev = resolve_device(device)
    return TickInputs(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=dev)
        for f in dataclasses.fields(TickInputs)
    })


def inputs_to_numpy(inputs: TickInputs) -> dict:
    """The lanes of ``inputs`` as numpy arrays keyed by name."""
    return {f.name: getattr(inputs, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(TickInputs)}


def outputs_from_numpy(arrays: dict, device="cuda") -> TickOutputs:
    """``TickOutputs`` on ``device`` from numpy lanes keyed by name (a
    lane absent or None stays None)."""
    dev = resolve_device(device)
    return TickOutputs(**{
        f.name: None if arrays.get(f.name) is None
        else torch.tensor(np.asarray(arrays[f.name]), device=dev)
        for f in dataclasses.fields(TickOutputs)})


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


def mega_outputs_to_numpy(outputs: MegaTickOutputs | MultiTickOutputs
                          ) -> dict:
    """The lanes of megaspace (or multi-space) ``outputs`` as numpy
    arrays; ``base`` is the dict of :func:`outputs_to_numpy`."""
    out = {f.name: getattr(outputs, f.name).detach().cpu().numpy()
           for f in dataclasses.fields(outputs) if f.name != "base"}
    out["base"] = outputs_to_numpy(outputs.base)
    return out
