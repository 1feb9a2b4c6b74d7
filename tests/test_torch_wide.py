"""Every behavior, registry scenario and member mix of
``tests/test_torch_scenarios.py`` at 4096 rows x 16 ticks against the
JAX package's tick on the CPU, each tick from the JAX state, bit for bit
(a file of its own, so a test worker takes it beside the scenarios').

The npc mix missed 7 words here (3 position, 4 velocity, at ticks 1, 8,
9 and 13; exact at 512 x 8) until its vmapped member's batched one-row
dots were read (``ops/mlp.py`` ``per_row``); all 11 cases take ~70 s on
one CPU. ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wide.py
ROWS TICKS`` prints the mismatched words at another size."""

import dataclasses

import jax
import numpy as np
import pytest

from goworld_tpu.core import state as jstate
from goworld_tpu.scenarios import spec as jspec
from goworld_tpu_torch.scenarios import spec as tspec

import test_torch_behaviors as tb
from test_torch_scenarios import MEMBER_MIXES, NAMES

WIDE = (4096, 16)
WIDE_CASES = ["btree", "mlp"] + list(NAMES) + sorted(MEMBER_MIXES)

def wide_diffs(name: str, n: int, ticks: int) -> dict:
    """Mismatched words of one behavior, scenario or member mix at ``n``
    rows over ``ticks`` ticks, each tick from the JAX state."""
    from goworld_tpu.models.npc_policy import init_policy as jinit

    from goworld_tpu_torch.models.npc_policy import init_policy

    mix = MEMBER_MIXES.get(name)
    if name in ("btree", "mlp"):
        jcfg, tcfg = tb.configs(n=n, behavior=name)
        lanes, inputs = tb.bench_lanes(jcfg)
        pol = name == "mlp"
    else:
        js_, ts_ = ((jspec.ScenarioSpec(name=name, mix=mix),
                     tspec.ScenarioSpec(name=name, mix=mix)) if mix
                    else (jspec.get_scenario(name),
                          tspec.get_scenario(name)))
        jcfg, tcfg = tb.configs(n=n, scenario=js_)
        tcfg = dataclasses.replace(tcfg, scenario=ts_)
        lanes, inputs = tb.bench_lanes(jcfg)
        st = jstate.create_state(jcfg, seed=1)
        lanes["behavior_id"] = np.asarray(st.behavior_id)
        lanes["aoi_radius"] = np.asarray(st.aoi_radius)
        pol = ts_.needs_policy
    diffs, _ = tb.run_ticks(
        jcfg, tcfg, lanes, inputs,
        jinit(jax.random.PRNGKey(5), 128) if pol else None,
        init_policy(5, 128, device="cpu") if pol else None, ticks)
    return diffs


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_ticks_match_jax(case):
    """Every behavior, scenario and member mix at 4096 rows x 16 ticks,
    bit for bit."""
    diffs = wide_diffs(case, *WIDE)
    assert not diffs, diffs


def wide_check(n: int, ticks: int) -> dict:
    """:func:`wide_diffs` of every case at another size, printed. Run
    as ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wide.py
    ROWS TICKS``."""
    out = {}
    for name in WIDE_CASES:
        out[name] = wide_diffs(name, n, ticks)
        print(name, n, ticks, out[name], flush=True)
    return out


if __name__ == "__main__":
    import sys

    wide_check(*(int(a) for a in sys.argv[1:3]))
