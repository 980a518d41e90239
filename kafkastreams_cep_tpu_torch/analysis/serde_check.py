"""serde: checkpoint field round-trip completeness.

A copy of the JAX package's `analysis/serde_check.py` with its bindings
remade over the port's codecs (state/serde.py). Two generalisations: a
producer may return ``encode(...)`` of a dict literal (the shard frame's
`ShardPipeline.checkpoint`), and a consumer row may name several
(function, dict variable) readers, a subscript of a direct call to the
decoder counting as a read of the decoded dict.

The bug class (the JAX package's gate-state bug): a field is added to a
checkpointed structure (or to a snapshot dict) and the serde frame
silently drops it -- the crash test that would catch it only exists if
someone remembered to extend it. This checker makes the omission
structural:

- **Structure bindings** (`STRUCT_BINDINGS`): for every serialized
  structure, every declared field must be (a) read somewhere in its
  encode function and (b) supplied to the structure's constructor (or
  written) in its decode function. Fields exempted by design carry
  ``# cep: serde-ok(reason)`` on their definition line.
- **Dict-state bindings** (`DICT_BINDINGS`): producer snapshot dicts
  (e.g. ``EventTimeGate.snapshot_state``) vs the encode/decode frame
  functions vs the consumer (``restore_state``): produced keys must be
  encoded, encoded keys decoded, decoded keys consumed.
  ``state.get("k", default)`` in an encoder marks `k` optional.

Findings:
    CEP-D01  field/key produced but never encoded
    CEP-D02  field/key encoded but never decoded
    CEP-D03  asymmetric frame (encode reads what nothing produces /
             decode writes what nothing consumes)

All findings anchor to the most actionable line (field definition,
snapshot return, or frame write) so a ``# cep: serde-ok(reason)``
pragma can audit the intentional cases in place.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile
from .zerosync import function_index

SERDE_PATH = "kafkastreams_cep_tpu_torch/state/serde.py"

#: (struct file, class, encode qual, decode qual) -- quals in SERDE_PATH.
STRUCT_BINDINGS = (
    ("kafkastreams_cep_tpu_torch/core/event.py", "Event", "put_event", "get_event"),
    (
        "kafkastreams_cep_tpu_torch/nfa/nfa.py", "ComputationStage",
        "CheckpointCodec.encode_nfa_states",
        "CheckpointCodec.decode_nfa_states",
    ),
    (
        "kafkastreams_cep_tpu_torch/state/nfa_store.py", "NFAStates",
        "CheckpointCodec.encode_nfa_states",
        "CheckpointCodec.decode_nfa_states",
    ),
    (
        "kafkastreams_cep_tpu_torch/state/buffer.py", "BufferNode",
        "CheckpointCodec.encode_buffer", "CheckpointCodec.decode_buffer",
    ),
)

#: (producer file, producer qual, consumer, encode qual, decode qual).
#: `consumer` is a qual (its second positional parameter is the dict, the
#: JAX rule) or a tuple of (qual, dict variable) readers in the producer's
#: file. The mesh's engine frames (parallel/key_shard.py, the engine's
#: `snapshot`) hold whole array trees joined over the shards
#: (`gather_state`): every leaf rides `encode_array_tree`, so no field
#: list exists to fall out of step, and the frames are held byte for byte
#: to the unsharded engine's by tests/test_torch_mesh.py.
DICT_BINDINGS = (
    (
        "kafkastreams_cep_tpu_torch/time/gate.py",
        "EventTimeGate.snapshot_state",
        "EventTimeGate.restore_state",
        "encode_event_time_state",
        "decode_event_time_state",
    ),
    (
        "kafkastreams_cep_tpu_torch/streams/rebalance.py",
        "ShardPipeline.checkpoint",
        (("ShardPipeline.__init__", "cp"), ("RebalanceController.migrate", "")),
        "encode_shard_checkpoint",
        "decode_shard_checkpoint",
    ),
)


# ---------------------------------------------------------------------------
# structure fields
# ---------------------------------------------------------------------------
def _class_node(src: SourceFile, name: str) -> Optional[ast.ClassDef]:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def struct_fields(
    src: SourceFile, cls: ast.ClassDef
) -> List[Tuple[str, int]]:
    """Declared (field, lineno) in definition order: dataclass-style
    annotations, else __slots__, else __init__ self.X writes."""
    fields: List[Tuple[str, int]] = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            fields.append((node.target.id, node.lineno))
    if fields:
        return fields
    for node in cls.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__slots__"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(
                    elt.value, str
                ):
                    fields.append((elt.value, node.lineno))
    if fields:
        return fields
    for node in cls.body:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "__init__"
        ):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            fields.append((t.attr, sub.lineno))
    return fields


def _init_params(cls: ast.ClassDef) -> Optional[List[str]]:
    for node in cls.body:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "__init__"
        ):
            args = node.args
            params = [
                a.arg
                for a in list(args.posonlyargs) + list(args.args)
                if a.arg != "self"
            ]
            return params
    return None


def _attr_reads(fn: ast.AST) -> Set[str]:
    return {
        node.attr
        for node in ast.walk(fn)
        if isinstance(node, ast.Attribute)
        and isinstance(node.ctx, ast.Load)
    }


def _ctor_fields(
    fn: ast.AST, cls_name: str, ordered_fields: List[str]
) -> Set[str]:
    """Fields supplied to `cls_name(...)` calls inside `fn` (keywords
    plus positionals mapped through the field order)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.id if isinstance(func, ast.Name) else (
            func.attr if isinstance(func, ast.Attribute) else None
        )
        if name != cls_name:
            continue
        for i, _arg in enumerate(node.args):
            if i < len(ordered_fields):
                out.add(ordered_fields[i])
        for kw in node.keywords:
            if kw.arg:
                out.add(kw.arg)
    return out


# ---------------------------------------------------------------------------
# dict-state keys
# ---------------------------------------------------------------------------
def _sub_key(node: ast.Subscript) -> Optional[str]:
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        return sl.value
    return None


def _called(node: ast.AST, name: Optional[str]) -> bool:
    """Is `node` a direct call of the function `name` (``f(...)`` or
    ``mod.f(...)``)?"""
    if name is None or not isinstance(node, ast.Call):
        return False
    func = node.func
    return (isinstance(func, ast.Name) and func.id == name) or (
        isinstance(func, ast.Attribute) and func.attr == name
    )


def dict_reads(
    fn: ast.AST, param: str, decoder: Optional[str] = None
) -> Tuple[Set[str], Set[str]]:
    """(required, optional) string keys read from `param` in `fn` (and,
    given `decoder`, from a direct call of it: ``decoder(b)["k"]``)."""
    required: Set[str] = set()
    optional: Set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Subscript)
            and (
                (isinstance(node.value, ast.Name) and node.value.id == param)
                or _called(node.value, decoder)
            )
            and isinstance(node.ctx, ast.Load)
        ):
            key = _sub_key(node)
            if key is not None:
                required.add(key)
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == param
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            optional.add(node.args[0].value)
    return required, optional


def dict_writes(fn: ast.AST) -> Dict[str, int]:
    """{key: lineno} written into the dict the function returns."""
    ret_name: Optional[str] = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(
            node.value, ast.Name
        ):
            ret_name = node.value.id
    out: Dict[str, int] = {}
    if ret_name is None:
        return out
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            if isinstance(node, ast.AnnAssign):
                if node.value is None:
                    continue
                targets = [node.target]
            else:
                targets = node.targets
            for t in targets:
                if (
                    isinstance(t, ast.Name)
                    and t.id == ret_name
                    and isinstance(node.value, ast.Dict)
                ):
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) and isinstance(
                            k.value, str
                        ):
                            out.setdefault(k.value, node.lineno)
                elif (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == ret_name
                ):
                    key = _sub_key(t)
                    if key is not None:
                        out.setdefault(key, node.lineno)
    return out


def returned_dict_keys(fn: ast.AST) -> Dict[str, int]:
    """{key: lineno} of a function returning a dict literal (or building
    one and returning it, or returning a call on a dict literal)."""
    out: Dict[str, int] = {}
    for node in ast.walk(fn):
        value = node.value if isinstance(node, ast.Return) else None
        if (
            isinstance(value, ast.Call)
            and value.args
            and isinstance(value.args[0], ast.Dict)
        ):
            value = value.args[0]  # return encode({...})
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.setdefault(k.value, k.lineno)
    if out:
        return out
    return dict_writes(fn)


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------
def check(files: Sequence[SourceFile], root_dir: str) -> List[Finding]:
    by_path = {src.relpath: src for src in files}
    serde = by_path.get(SERDE_PATH)
    if serde is None:
        return []  # partial run without the serde module
    serde_fns = function_index(serde)
    findings: List[Finding] = []

    for struct_path, cls_name, enc_qual, dec_qual in STRUCT_BINDINGS:
        struct_src = by_path.get(struct_path)
        enc = serde_fns.get(enc_qual)
        dec = serde_fns.get(dec_qual)
        if struct_src is None or enc is None or dec is None:
            if enc is None or dec is None:
                findings.append(
                    Finding(
                        "serde", "CEP-D03", SERDE_PATH, 0,
                        f"serde binding for {cls_name} names missing "
                        f"function(s) {enc_qual!r}/{dec_qual!r} -- update "
                        "analysis/serde_check.py",
                        context=f"binding:{cls_name}",
                    )
                )
            continue
        cls = _class_node(struct_src, cls_name)
        if cls is None:
            findings.append(
                Finding(
                    "serde", "CEP-D03", struct_path, 0,
                    f"serde binding names missing class {cls_name!r} -- "
                    "update analysis/serde_check.py",
                    context=f"binding:{cls_name}",
                )
            )
            continue
        fields = struct_fields(struct_src, cls)
        ordered = _init_params(cls) or [f for f, _ in fields]
        enc_reads = _attr_reads(enc)
        dec_supplied = _ctor_fields(dec, cls_name, ordered)
        for fname, line in fields:
            if struct_src.suppression(line, "serde") is not None:
                continue
            if fname not in enc_reads:
                findings.append(
                    Finding(
                        "serde", "CEP-D01", struct_path, line,
                        f"{cls_name}.{fname} is never read by "
                        f"{enc_qual} -- the checkpoint frame drops it",
                        context=f"{cls_name}.{fname}:encode",
                    )
                )
            if fname not in dec_supplied:
                findings.append(
                    Finding(
                        "serde", "CEP-D02", struct_path, line,
                        f"{cls_name}.{fname} is never supplied by "
                        f"{dec_qual} -- restore loses it",
                        context=f"{cls_name}.{fname}:decode",
                    )
                )

    for (
        prod_path, prod_qual, cons_qual, enc_qual, dec_qual
    ) in DICT_BINDINGS:
        prod_src = by_path.get(prod_path)
        enc = serde_fns.get(enc_qual)
        dec = serde_fns.get(dec_qual)
        if prod_src is None or enc is None or dec is None:
            if enc is None or dec is None:
                findings.append(
                    Finding(
                        "serde", "CEP-D03", SERDE_PATH, 0,
                        f"dict binding names missing function(s) "
                        f"{enc_qual!r}/{dec_qual!r} -- update "
                        "analysis/serde_check.py",
                        context=f"binding:{enc_qual}",
                    )
                )
            continue
        prod_fns = function_index(prod_src)
        prod = prod_fns.get(prod_qual)
        readers = (
            ((cons_qual, None),) if isinstance(cons_qual, str) else cons_qual
        )
        cons_fns = [(prod_fns.get(q), var) for q, var in readers]
        if prod is None or any(fn is None for fn, _var in cons_fns):
            findings.append(
                Finding(
                    "serde", "CEP-D03", prod_path, 0,
                    f"dict binding names missing function(s) "
                    f"{prod_qual!r}/{cons_qual!r} -- update "
                    "analysis/serde_check.py",
                    context=f"binding:{prod_qual}",
                )
            )
            continue
        if not isinstance(cons_qual, str):
            cons_qual = "/".join(q for q, _var in readers)
        produced = returned_dict_keys(prod)
        enc_param = enc.args.args[0].arg if enc.args.args else "state"
        enc_required, enc_optional = dict_reads(enc, enc_param)
        enc_all = enc_required | enc_optional
        decoded = dict_writes(dec)
        cons_all: Set[str] = set()
        for cons, var in cons_fns:
            if var is None:
                var = (
                    cons.args.args[1].arg
                    if len(cons.args.args) > 1
                    else "state"
                )
            cons_required, cons_optional = dict_reads(
                cons, var, dec_qual.rsplit(".", 1)[-1]
            )
            cons_all |= cons_required | cons_optional

        for key, line in sorted(produced.items()):
            if key not in enc_all:
                findings.append(
                    Finding(
                        "serde", "CEP-D01", prod_path, line,
                        f"{prod_qual} produces key {key!r} but "
                        f"{enc_qual} never encodes it -- the checkpoint "
                        "frame drops it (the gate-state bug class)",
                        context=f"{prod_qual}:{key}",
                    )
                )
        for key in sorted(enc_required - set(produced)):
            findings.append(
                Finding(
                    "serde", "CEP-D03", SERDE_PATH, enc.lineno,
                    f"{enc_qual} requires key {key!r} that {prod_qual} "
                    "never produces (use .get() if optional)",
                    context=f"{enc_qual}:{key}",
                )
            )
        for key in sorted(enc_all - set(decoded)):
            findings.append(
                Finding(
                    "serde", "CEP-D02", SERDE_PATH, enc.lineno,
                    f"{enc_qual} encodes key {key!r} but {dec_qual} "
                    "never decodes it -- restore loses it",
                    context=f"{enc_qual}:{key}:undecoded",
                )
            )
        for key, line in sorted(decoded.items()):
            if key not in enc_all:
                findings.append(
                    Finding(
                        "serde", "CEP-D03", SERDE_PATH, line,
                        f"{dec_qual} writes key {key!r} that {enc_qual} "
                        "never encodes",
                        context=f"{dec_qual}:{key}:unencoded",
                    )
                )
            if key not in cons_all:
                findings.append(
                    Finding(
                        "serde", "CEP-D03", SERDE_PATH, line,
                        f"{dec_qual} decodes key {key!r} that {cons_qual} "
                        "never consumes",
                        context=f"{dec_qual}:{key}:unconsumed",
                    )
                )
    return findings
