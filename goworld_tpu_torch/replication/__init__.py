"""Hot-standby replication, the port's copy of
``goworld_tpu/replication/``: streaming delta replication
from a primary game to a warm standby, plus the promotion protocol
that turns a crash from a cold restore (seconds of full-world
serialization) into a warm promotion (a few ticks of applied lag).

Layout:

* :mod:`frames`  — the in-band stream format: SnapshotChain v2 records
  (freeze.py keyframe/delta planes) wrapped in CRC-chained envelopes;
  encoder, torn-stream detecting decoder, in-memory delta resolution.
* :mod:`worker`  — the bounded off-thread replication worker: the tick
  thread captures cheaply, the worker runs the chain diff, writes the
  disk chain (so no chain write runs on the tick thread) and ships
  stream frames; backlog degrades to keyframe cadence, loudly.
* :mod:`standby` — the standby-side applier (frames -> live world +
  EntityLedger resync), the lag tracker behind the ``/standby``
  endpoint, and its process-local registry.
* :mod:`promote` — the kvreg-arbitrated single-winner promotion claim
  (epoch-guarded both ways so a replayed stale claim and a zombie
  primary both lose) and the byte-replayable decision log.
"""

from goworld_tpu_torch.replication.frames import (  # noqa: F401
    REPLICATION_STREAM_VERSION,
    StreamDecoder,
    StreamEncoder,
    TornStreamError,
)
from goworld_tpu_torch.replication.promote import (  # noqa: F401
    DecisionLog,
    adjudicate,
    claim_key,
    claim_value,
    parse_claim,
)
from goworld_tpu_torch.replication.standby import (  # noqa: F401
    StandbyApplier,
    StandbyTracker,
    register,
    snapshot_all,
    unregister,
)
from goworld_tpu_torch.replication.worker import ReplicationWorker  # noqa: F401
