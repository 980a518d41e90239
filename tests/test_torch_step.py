"""The CUDA step kernel's source against the plain PyTorch step.

The kernel (kafkastreams_cep_tpu_torch/csrc/nfa_step.cu) runs only on the
card; `chip_smoke.py` holds it bitwise to the plain step there. On the
CPU this file compiles the same source with g++ under csrc/cpu_emu.h
(OS threads for CUDA threads, barriers for __syncthreads and for each
warp's shuffles) and holds its outputs bitwise to the plain step on the
three conformance cases, along a gc_group=4 run with a watermark column
(so the kernel sees nonzero gc_phase and the wm clock). The plain step is
itself held to the JAX engine in tests/test_torch_batched.py.
"""
import random
import shutil
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

torch.set_num_threads(1)

import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, TS0  # noqa: E402
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
    gc_group=4 and a per-event watermark column (some ahead of ts)."""
    stream = CASES[case][2]
    query, config = _query_config(case)
    eng = P.BatchedDeviceNFA(query, keys=KEYS, config=config, device=device,
                             engine="torch")
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


def _bad_leaves(a, b):
    return [n for n in a if a[n].dtype != b[n].dtype or not torch.equal(a[n], b[n])]


@pytest.fixture(scope="module")
def cpu_libraries():
    """The emulation build of every case's kernel, all compiled at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    with ThreadPoolExecutor(len(CASES)) as ex:
        futs = {case: ex.submit(sk.build_library, *_query_config(case), target="cpu")
                for case in CASES}
        return {case: f.result() for case, f in futs.items()}


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
    query = P.compile_query(P.compile_pattern(CASES["letters"][0]()), None)
    with pytest.raises(ValueError, match="lanes"):
        sk.NfaStep(query, P.EngineConfig(lanes=2048))


def test_kernel_matches_plain_step_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison on the H100")
    for case in sorted(CASES):
        query, config, pairs = _trajectory(case, device="cuda")
        plain = build_plain_step(query, config)
        step = sk.NfaStep(query, config)
        for state, xs in pairs:
            s1, y1 = plain(state, xs)
            s2, y2 = step(state, xs)
            torch.cuda.synchronize()
            assert not _bad_leaves(s1, s2) and not _bad_leaves(y1, y2), case
