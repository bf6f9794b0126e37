"""The paper's access scheme as a value: ``Protocol`` and the accounting of
one ``aggregate`` call."""

from repro_torch.protocol.protocol import (  # noqa: F401
    KINDS, Protocol, ProtocolAccounting,
)

__all__ = ["KINDS", "Protocol", "ProtocolAccounting"]
