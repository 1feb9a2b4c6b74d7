"""Per-tick inputs of a sharded Space, the port of
``goworld_tpu/parallel/step.py``'s ``MultiTickInputs``.

The JAX package's ``make_multi_tick`` (independent Spaces with
host-requested migration) is not ported yet; see ROADMAP.md Queue A.
"""

from __future__ import annotations

import dataclasses

import torch

from goworld_tpu_torch.core.state import WorldConfig, resolve_device
from goworld_tpu_torch.core.step import TickInputs


@dataclasses.dataclass(frozen=True)
class MultiTickInputs:
    base: TickInputs              # lanes [n_dev, ...]
    migrate_target: torch.Tensor  # i32[n_dev, N]: dest shard or -1
    migrate_tag: torch.Tensor     # i32[n_dev, N]: host tag for remapping

    @staticmethod
    def empty(cfg: WorldConfig, n_dev: int,
              device="cuda") -> "MultiTickInputs":
        dev = resolve_device(device)
        one = TickInputs.empty(cfg, device=dev)
        base = TickInputs(**{
            f.name: getattr(one, f.name).expand(
                (n_dev,) + getattr(one, f.name).shape).contiguous()
            for f in dataclasses.fields(TickInputs)
        })
        return MultiTickInputs(
            base=base,
            migrate_target=torch.full((n_dev, cfg.capacity), -1,
                                      dtype=torch.int32, device=dev),
            migrate_tag=torch.full((n_dev, cfg.capacity), -1,
                                   dtype=torch.int32, device=dev),
        )
