"""The constants this package shares with the JAX package's
``goworld_tpu/utils/consts.py``, copied so that the port imports nothing
of it. One config must mean the same thing on both sides, so every
value here equals its counterpart there."""

# device tick rate target
TICK_HZ = 60

# kernel capacity defaults
DEFAULT_CAPACITY = 16384          # entity slots per space shard
DEFAULT_MAX_NEIGHBORS = 64        # K: AOI interest cap per entity
DEFAULT_CELL_CAP = 32             # max candidates considered per grid cell
DEFAULT_EVENT_CAP = 4096          # enter/leave events surfaced per tick
DEFAULT_SYNC_CAP = 16384          # sync records surfaced per tick
DEFAULT_INPUT_CAP = 4096          # client position-sync inputs per tick
DEFAULT_ROW_BLOCK = 32768         # AOI row-block size (memory ceiling knob)

# AOI sweep implementation defaults (GridSpec knobs)
DEFAULT_SWEEP_IMPL = "ranges"
DEFAULT_TOPK_IMPL = "sort"
DEFAULT_SORT_IMPL = "argsort"
DEFAULT_AOI_SKIN = 0.0
DEFAULT_PRECISION = "off"
PRECISION_POS_BITS = 15

# Packed-key id width: slot ids share an int32 with the quantized
# distance, so the packed paths (and the fused sweep) need n < 2^AOI_ID_BITS.
AOI_ID_BITS = 21

# the World's runtime knobs, as in the JAX package
DEFAULT_SAVE_INTERVAL = 300.0     # periodic entity save, seconds
OPTIMIZE_LOCAL_ENTITY_CALL = True  # post local RPCs straight to the
                                   # target instead of the remote router
