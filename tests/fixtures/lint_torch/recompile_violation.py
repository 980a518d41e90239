"""Seeded kernel-build hazards: every class the port's checker flags.

Mutation fixture for tests/test_torch_lint.py. NOT runnable production
code.
"""
import functools

from kafkastreams_cep_tpu_torch.ops.kernel_build import compile_source
from kafkastreams_cep_tpu_torch.ops.step_kernel import NfaStep

_LIBS = {}  # a module-level build cache


def churn(sources):
    out = []
    for src in sources:
        out.append(compile_source(src, "k"))     # CEP-R01: a build a pass
    return out


# cep: hot-path
def hot_step(state, xs, query, config):
    step = NfaStep(query, config)                # CEP-R02: a build an advance
    return step(state, xs)


def cached(src, flags):
    return _LIBS.get([src, flags])               # CEP-R03: unhashable key


@functools.lru_cache(maxsize=None)
def build_for(query, options={}):                # CEP-R03: mutable default
    return query, options
