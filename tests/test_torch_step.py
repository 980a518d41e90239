"""The CUDA step kernel's source against the plain PyTorch step.

The kernel (kafkastreams_cep_tpu_torch/csrc/nfa_step.cu) runs only on the
card; `chip_smoke.py` holds it bitwise to the plain step there. On the
CPU this file compiles the same source with g++ under csrc/cpu_emu.h
(OS threads for CUDA threads, a barrier for __syncthreads and one per
warp for its shuffles, ballots and __syncwarp) and holds its outputs
bitwise to the plain step, on every leaf:

  * the conformance cases of models/cases.py (`repeat` proceeds from a
    looping stage straight into a stage of the same name), along a
    gc_group=4 run with a watermark column (so the kernel sees nonzero
    gc_phase and the wm clock);
  * the cases of models/chunked.py, which reach the kernel's multi-chunk
    path (a key with more than 32 live lanes, walked 32 at a time with
    running rank bases): the flagship skip_any8 deployment at lanes=96,
    the same at lanes=24 (lane overflow), and the stock fold pattern at
    lanes=64 (the fold detector across chunks); each asserts that it got
    there;
  * an entry state whose live lanes are not a prefix (with run ids
    shared across chunks, so the fold detector fires), and a key whose
    events are all padding (its state must come back as it came in);
  * stacked queries past the single-word stage and predicate masks
    (models/stacked.py): eight rotations of the flagship pattern, 72
    stages and 120 predicates (two words of each), and letter queries
    stacked to 64 stages (the last single-word stage mask) and 65 (a query
    straddles the word boundary); at the widest masks, letter queries
    stacked to 256 stages and 193 predicates (4 words of each), and
    seventeen rotations, 153 stages and 255 predicates (3 and 4 words);
  * the generated source of every case of at most 64 stages and 64
    predicates, pinned to the digests it had before wide masks existed.

The plain step is itself held to the JAX engine in
tests/test_torch_batched.py.
"""
import dataclasses
import hashlib
import random
import shutil
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, TS0  # noqa: E402
from kafkastreams_cep_tpu_torch.models import cases, skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.chunked import (  # noqa: E402
    CHUNKED, CHUNKED_T, scatter_live_lanes,
)
from kafkastreams_cep_tpu_torch.models.stacked import (  # noqa: E402
    boundary_queries, rotated_skip_any_queries,
)
from kafkastreams_cep_tpu_torch.ops.codegen import wide_masks  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.tables import compile_multi_query  # noqa: E402
from kafkastreams_cep_tpu_torch.ops import step_kernel as sk  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.step import build_plain_step  # noqa: E402

K, T, N_BATCHES = 8, 10, 3
KEYS = [f"k{i}" for i in range(K)]
def _query_config(case):
    pattern, fields, stream, cfg = CASES[case]
    query = P.compile_query(P.compile_pattern(pattern()),
                            P.EventSchema(fields) if fields else None)
    return query, P.EngineConfig(**cfg, gc_group=4)


def _trajectory(case, device="cpu"):
    """(query, config, [(state, xs)]) along a plain-step run with
    gc_group=4 and a per-event watermark column (some ahead of ts). Exact
    replay is off, so the drains leave the GC group open (armed, a drain
    flushes the group first) and the kernel sees a nonzero gc_phase."""
    stream = CASES[case][2]
    query, config = _query_config(case)
    eng = P.BatchedDeviceNFA(query, keys=KEYS, config=config, device=device,
                             engine="torch", exact_replay=False)
    rng = random.Random(5)
    streams = {k: stream(rng, T * N_BATCHES) for k in KEYS}
    pairs = []
    for b in range(N_BATCHES):
        wm = {k: [TS0 + b * T + i - 3 + 2 * (j % 4) for i in range(T)]
              for j, k in enumerate(KEYS)}
        xs = eng.pack({k: s[b * T:(b + 1) * T] for k, s in streams.items()}, wm)
        pairs.append((eng.state, xs))
        eng.advance_packed(xs)
    return query, config, pairs


def _chunked_query_config(name):
    pattern, fields, _stream, _seed, cfg = CHUNKED[name]
    query = P.compile_query(P.compile_pattern(pattern()),
                            P.EventSchema(fields) if fields else None)
    return query, P.EngineConfig(**cfg)


#: name -> (stacked queries, stream, stream seed, EngineConfig keywords).
STACKED = {
    "wide72": (rotated_skip_any_queries, skip_any.skip_any8_stream, 7,
               dict(skip_any.FLAGSHIP_CONFIG, lanes=256, matches_per_step=64,
                    nodes_per_step=256)),
    "boundary64": (lambda: boundary_queries(64), cases.letters_stream, 5,
                   dict(lanes=64, nodes=1024, matches=256, matches_per_step=32,
                        nodes_per_step=32)),
    "boundary65": (lambda: boundary_queries(65), cases.letters_stream, 5,
                   dict(lanes=64, nodes=1024, matches=256, matches_per_step=32,
                        nodes_per_step=32)),
    "boundary256": (lambda: boundary_queries(256), cases.letters_stream, 5,
                    dict(lanes=128, nodes=2048, matches=1024, matches_per_step=128,
                         nodes_per_step=128)),
    "rotations17": (lambda: rotated_skip_any_queries(17), skip_any.skip_any8_stream, 7,
                    dict(skip_any.FLAGSHIP_CONFIG, lanes=512, matches_per_step=128,
                         nodes_per_step=512)),
}
#: name -> (stages, predicates, mask words of each) of the STACKED cases.
STACKED_SHAPES = {"wide72": (72, 120, 2, 2), "boundary64": (64, 48, 1, 1),
                  "boundary65": (65, 49, 2, 1), "boundary256": (256, 193, 4, 4),
                  "rotations17": (153, 255, 3, 4)}
STACKED_BATCHES = 2

#: sha256 of `kernel_source` for every case of at most 64 stages and 64
#: predicates, taken from the source before wide masks were added: their
#: kernels must not change.
NARROW_SOURCE_DIGESTS = {
    "letters": "41e1e93279284590675b2eaa44c589071010eee7c5647caf303a66aedccd5951",
    "stock": "961a5bf3d70c92ea0e35f0ca3aa3202f9e40a0095bffc3be9e198d3c0e471e69",
    "skip2": "b4325b11ec4609a0c4a4d1804af23f706b2a9ee70608d5115a1df92e1f73fb12",
    "repeat": "71d8c454dbbb8e50b286417ae0c753856bed5113a27001434988b4207c7e82e9",
    "chunked:skip_any8_lanes96": "f7108f3963765a546f021da9317ccde39d71602cc25fe98713b5f9cb98d42590",
    "chunked:skip_any8_lanes24": "0ba9e9b26fd56e3d2dc9d98c156dbc10b07aeefe4b4bcb857acb821d5869cd85",
    "chunked:stock_lanes64": "816d03cb7e548b508a3f0c2f844ecff3cf8f32c4313188bce90890afa8a63790",
    "flagship": "548628f9993692957221b91c9f9495128b69ba5cb761f6cc047bbbdc0ae6ee5c",
    "branchy:3": "b3e2b317e80677930e29a63f94e0bdc62abbe3f437271f1a8dd0a47ab15c2b85",
    "branchy:65": "be6dada3a6abedae0fbee5c155039e9b6d5f6623f80cbcd22414ae11bbec8a3a",
    "branchy:72": "3e8f30966a3023a19232b083c8091eb8b557a5fe6d056f88b3859f4639b8913f",
}


def _narrow_case(name):
    """(query, config) of a NARROW_SOURCE_DIGESTS entry."""
    kind, _, arg = name.partition(":")
    if kind in CASES:
        return _query_config(kind)[0], P.EngineConfig(**CASES[kind][3])
    if kind == "chunked":
        return _chunked_query_config(arg)
    if kind == "flagship":
        query = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
        return query, P.EngineConfig(**skip_any.FLAGSHIP_CONFIG)
    pattern, _ = cases.branchy_case(int(arg), ["k"])
    return (P.compile_query(P.compile_pattern(pattern), None),
            P.EngineConfig(lanes=64, nodes=512, matches=64, matches_per_step=16,
                           nodes_per_step=32))


def _stacked_query_config(name):
    queries = STACKED[name][0]
    return compile_multi_query(queries()), P.EngineConfig(**STACKED[name][3])


def _stacked_trajectory(name):
    """(query, config, [(state, xs)]) along a plain-step run of K keys x
    CHUNKED_T events x STACKED_BATCHES batches of a stacked case."""
    stream, seed = STACKED[name][1:3]
    query, config = _stacked_query_config(name)
    eng = P.BatchedDeviceNFA(query, keys=KEYS, config=config, device="cpu", engine="torch")
    rng = random.Random(seed)
    streams = {k: stream(rng, CHUNKED_T * STACKED_BATCHES) for k in KEYS}
    pairs = []
    for b in range(STACKED_BATCHES):
        xs = eng.pack({k: s[b * CHUNKED_T:(b + 1) * CHUNKED_T] for k, s in streams.items()})
        pairs.append((eng.state, xs))
        eng.advance_packed(xs)
    return query, config, pairs


def _chunked_trajectory(name, device="cpu"):
    """(query, config, [(state, xs)]) along a plain-step run of K keys x
    CHUNKED_T events x 3 batches of a models/chunked.py case."""
    stream, seed = CHUNKED[name][2:4]
    query, config = _chunked_query_config(name)
    eng = P.BatchedDeviceNFA(query, keys=KEYS, config=config, device=device,
                             engine="torch")
    rng = random.Random(seed)
    streams = {k: stream(rng, CHUNKED_T * N_BATCHES) for k in KEYS}
    pairs = []
    for b in range(N_BATCHES):
        xs = eng.pack({k: s[b * CHUNKED_T:(b + 1) * CHUNKED_T] for k, s in streams.items()})
        pairs.append((eng.state, xs))
        eng.advance_packed(xs)
    return query, config, pairs


def _bad_leaves(a, b):
    return [n for n in a if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n])]


def _assert_kernel_equals_plain(lib, query, config, state, xs, label):
    s1, y1 = build_plain_step(query, config)(state, xs)
    s2, y2 = sk.launch(lib, query, config, state, xs)
    assert not _bad_leaves(s1, s2), f"{label}: state {_bad_leaves(s1, s2)}"
    assert not _bad_leaves(y1, y2), f"{label}: ys {_bad_leaves(y1, y2)}"
    return s1


@pytest.fixture(scope="module")
def cpu_libraries():
    """The emulation build of every case's kernel, all compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    builds = {case: _query_config(case) for case in CASES}
    builds.update({name: _chunked_query_config(name) for name in CHUNKED})
    builds.update({name: _stacked_query_config(name) for name in STACKED})
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {name: ex.submit(sk.build_library, q, c, target="cpu")
                for name, (q, c) in builds.items()}
        return {name: f.result() for name, f in futs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain_step_on_cpu(case, cpu_libraries):
    query, config, pairs = _trajectory(case)
    lib = sk.load_library(cpu_libraries[case])
    plain = build_plain_step(query, config)
    assert any(int(state["gc_phase"][0]) > 0 for state, _ in pairs)
    for b, (state, xs) in enumerate(pairs):
        s1, y1 = plain(state, xs)
        s2, y2 = sk.launch(lib, query, config, state, xs)
        assert not _bad_leaves(s1, s2), f"{case} batch {b}: state {_bad_leaves(s1, s2)}"
        assert not _bad_leaves(y1, y2), f"{case} batch {b}: ys {_bad_leaves(y1, y2)}"


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_kernel_source_matches_plain_step_past_one_chunk(name, cpu_libraries):
    query, config, pairs = _chunked_trajectory(name)
    lib = sk.load_library(cpu_libraries[name])
    outs = [_assert_kernel_equals_plain(lib, query, config, state, xs, f"{name} batch {b}")
            for b, (state, xs) in enumerate(pairs)]
    if config.lanes > 32:
        live = max(int(s["active"].sum(0).max()) for s in outs)
        assert live > 32, f"{name}: at most {live} live lanes in a key at a batch end"
    else:
        assert int(outs[-1]["lane_drops"].sum()) > 0, f"{name}: no lane overflow"
    if query.folds and any(query.folds):
        assert config.lanes > 32


@pytest.mark.parametrize("name", sorted(STACKED))
def test_kernel_source_matches_plain_step_on_stacked_queries(name, cpu_libraries):
    """Stacked tables: begin lanes of every query, a union stage table,
    and past 64 stages or predicates the multi-word masks."""
    query, config, pairs = _stacked_trajectory(name)
    n_stages, n_preds, stage_words, pred_words = STACKED_SHAPES[name]
    assert (query.n_stages, query.n_preds) == (n_stages, n_preds)
    assert (-(-n_stages // 64), -(-n_preds // 64)) == (stage_words, pred_words)
    assert wide_masks(query) == (name != "boundary64")
    lib = sk.load_library(cpu_libraries[name])
    outs = [_assert_kernel_equals_plain(lib, query, config, state, xs, f"{name} batch {b}")
            for b, (state, xs) in enumerate(pairs)]
    # The rotation stacks walk past one chunk; the letter stacks hold
    # about one run per query.
    live = max(int(s["active"].sum(0).max()) for s in outs)
    assert live > (32 if name in ("wide72", "rotations17") else 16)
    assert all(int(s[c].sum()) == 0 for s in outs
               for c in ("lane_drops", "node_drops", "match_drops"))


@pytest.mark.parametrize("name", sorted(NARROW_SOURCE_DIGESTS))
def test_kernel_source_of_narrow_queries_is_unchanged(name):
    query, config = _narrow_case(name)
    assert not wide_masks(query)
    digest = hashlib.sha256(sk.kernel_source(query, config).encode()).hexdigest()
    assert digest == NARROW_SOURCE_DIGESTS[name]


def test_kernel_source_compacts_an_entry_state_that_is_not_a_prefix(cpu_libraries):
    """Stock folds at lanes=64, from the state before batch 2, its live
    lanes scattered. In the key with the most live lanes, the lane of
    rank i + 32 takes the run id of the lane of rank i: only ids shared
    across chunks, so the fold detector fires only if it compares across
    chunks against the event-start table."""
    query, config, pairs = _chunked_trajectory("stock_lanes64")
    lib = sk.load_library(cpu_libraries["stock_lanes64"])
    state, xs = pairs[1]
    k = int(state["active"].sum(0).argmax())
    live = torch.nonzero(state["active"][:, k]).flatten()
    assert len(live) > 32
    state = {n: v.clone() for n, v in state.items()}
    for i in range(len(live) - 32):
        state["seq"][live[i + 32], k] = state["seq"][live[i], k]
    state = scatter_live_lanes(state, 11)
    assert not bool(state["active"][: len(live), k].all())  # not a prefix
    out = _assert_kernel_equals_plain(lib, query, config, state, xs, "scattered entry")
    assert int(out["seq_collisions"][k]) > int(state["seq_collisions"][k])


def test_kernel_source_returns_an_all_padding_key_unchanged(cpu_libraries):
    """skip_any8 at lanes=96 from a scattered state (arbitrary values in
    the inactive lanes): a key whose T events are all padding comes back
    bitwise as it came in, the other keys advance."""
    query, config, pairs = _chunked_trajectory("skip_any8_lanes96")
    lib = sk.load_library(cpu_libraries["skip_any8_lanes96"])
    state, xs = pairs[1]
    state = scatter_live_lanes(state, 12)
    xs = dict(xs)
    xs["valid"] = xs["valid"].clone()
    xs["valid"][:, 3] = False
    out = _assert_kernel_equals_plain(lib, query, config, state, xs, "all-padding key")
    for n in state:
        assert torch.equal(out[n][..., 3], state[n][..., 3]), n
    assert int(out["n_events"].sum()) > int(state["n_events"].sum())


def test_wrapper_runs_plain_version_for_cpu_tensors():
    query, config, pairs = _trajectory("letters")
    step = sk.NfaStep(query, config)
    before = sk.NfaStep.launches
    state, xs = pairs[-1]
    s1, y1 = step(state, xs)
    s2, y2 = build_plain_step(query, config)(state, xs)
    assert not _bad_leaves(s1, s2) and not _bad_leaves(y1, y2)
    assert sk.NfaStep.launches == before  # nothing was launched


def test_wrapper_refuses_shapes_outside_the_envelope():
    """A key's lanes live in the kernel's scratch, so any lane count is
    taken, and 256 stages and 256 predicates are (multi-word masks); a
    descent deeper than the 64-bit slot masks hold, or more stages or
    predicates than the widest masks hold, is not."""
    query = P.compile_query(P.compile_pattern(CASES["letters"][0]()), None)
    sk.NfaStep(query, P.EngineConfig(lanes=2048))
    sk.NfaStep(dataclasses.replace(query, n_stages=256, n_preds=256), P.EngineConfig())
    with pytest.raises(ValueError, match="descent depth"):
        sk.NfaStep(dataclasses.replace(query, max_depth=22), P.EngineConfig())
    with pytest.raises(ValueError, match="stages"):
        sk.NfaStep(dataclasses.replace(query, n_stages=257), P.EngineConfig())
    with pytest.raises(ValueError, match="predicates"):
        sk.NfaStep(dataclasses.replace(query, n_preds=257), P.EngineConfig())


def test_kernel_matches_plain_step_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    runs = [_trajectory(case, device="cuda") for case in sorted(CASES)]
    runs += [_chunked_trajectory(name, device="cuda") for name in sorted(CHUNKED)]
    for case, (query, config, pairs) in zip(sorted(CASES) + sorted(CHUNKED), runs):
        plain = build_plain_step(query, config)
        step = sk.NfaStep(query, config)
        for state, xs in pairs:
            s1, y1 = plain(state, xs)
            s2, y2 = step(state, xs)
            torch.cuda.synchronize()
            assert not _bad_leaves(s1, s2) and not _bad_leaves(y1, y2), case
