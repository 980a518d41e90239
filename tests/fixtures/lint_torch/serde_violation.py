"""Seeded serde-completeness violations (the gate-state bug class).

Encode/decode pairs that drop fields; bound to serde_structs.py by
tests/test_torch_lint.py via monkeypatched STRUCT_BINDINGS/DICT_BINDINGS.
NOT runnable production code.
"""
from typing import Any, Dict


def encode_record(w, rec) -> None:
    w.i64(rec.a)
    w.i64(rec.b)  # rec.c never written: CEP-D01


def decode_record(r):
    from .serde_structs import Record

    return Record(a=r.i64(), b=r.i64(), c=0, skipme=0)  # c supplied; fine


def encode_gate_state(state: Dict[str, Any]) -> bytes:
    # reads x and y; 'z' from snapshot_state is dropped: CEP-D01
    return b"%d,%d" % (state["x"], state["y"])


def decode_gate_state(data: bytes) -> Dict[str, Any]:
    x, y = data.split(b",")
    out: Dict[str, Any] = {"x": int(x), "y": int(y)}
    out["q"] = 0  # never encoded: CEP-D03; 'y' never consumed: CEP-D03
    return out


def encode_shard(shard: Dict[str, Any]) -> bytes:
    # reads id and pos; 'lost' from Shard.checkpoint is dropped: CEP-D01
    return b"%d,%d" % (shard["id"], shard["pos"])


def decode_shard(data: bytes) -> Dict[str, Any]:
    i, p = data.split(b",")
    return_value: Dict[str, Any] = {"id": int(i), "pos": int(p)}
    return return_value
