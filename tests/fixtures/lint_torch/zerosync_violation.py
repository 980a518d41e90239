"""Seeded zero-sync violations: every construct the port's checker flags.

Mutation fixture for tests/test_torch_lint.py -- the port's gate must
exit 1 on this file (the gate is proven able to fail). NOT runnable
production code.
"""
import numpy as np
import torch


# cep: hot-path
def hot_advance(state, xs):
    occupancy = torch.amax(state["pend_pos"])       # a tensor
    n = int(occupancy)                              # CEP-S02 scalarization
    host = np.asarray(xs["gidx"])                   # CEP-S01 materialize
    torch.cuda.synchronize()                        # CEP-S01 hard sync
    state["runs"].item()                            # CEP-S01 .item()
    if occupancy > 0:                               # CEP-S03 truthiness
        n += 1
    flag = bool(xs["valid"])                        # CEP-S02 bool()
    return n, host, flag


def cold_helper(state):
    """Not hot-path marked: the same constructs are fine here."""
    return int(torch.amax(state["pend_pos"]))
