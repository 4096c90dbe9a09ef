"""Walker sharding over several devices (see :mod:`.mesh`)."""

from .mesh import (  # noqa: F401
    WalkerMesh,
    check_divisible,
    make_mesh,
    replicate,
    resolve_mesh,
    shard_batch,
    sharded_log_prob,
)
