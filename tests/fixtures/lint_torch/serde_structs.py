"""Structures for the seeded serde-completeness violations.

Paired with serde_violation.py via monkeypatched bindings in
tests/test_torch_lint.py. NOT runnable production code.
"""
from dataclasses import dataclass
from typing import Any, Dict

from .serde_violation import decode_shard, encode_shard


@dataclass
class Record:
    a: int
    b: int
    c: int  # encode in serde_violation.py drops this field
    skipme: int = 0  # cep: serde-ok(derived at load time; fixture pragma)


class Gate:
    def snapshot_state(self) -> Dict[str, Any]:
        return {"x": 1, "y": 2, "z": 3}  # 'z' is never encoded

    def restore_state(self, state: Dict[str, Any]) -> None:
        self.x = state["x"]  # 'y' decoded but never consumed


class Shard:
    def checkpoint(self) -> bytes:
        return encode_shard({"id": 1, "pos": 2, "lost": 3})  # 'lost' never encoded

    def adopt(self, blob: bytes) -> None:
        cp = decode_shard(blob)
        self.id = cp["id"]


def sessions_of(blob: bytes) -> Any:
    return decode_shard(blob)["pos"]
