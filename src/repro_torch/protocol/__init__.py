"""The paper's access scheme as a value: ``Protocol``, the accounting of
one ``aggregate`` call, and the ``BitsSchedule`` depth policies."""

from repro_torch.protocol.protocol import (  # noqa: F401
    KINDS, Protocol, ProtocolAccounting,
)
from repro_torch.protocol.schedule import (  # noqa: F401
    BitsSchedule, CollisionAdaptiveBits, FixedBits,
)

__all__ = ["KINDS", "Protocol", "ProtocolAccounting", "BitsSchedule",
           "CollisionAdaptiveBits", "FixedBits"]
