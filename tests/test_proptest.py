"""The property harness itself: `proptest.given` draws case i from its own seed,
exactly as a hand-written loop over the seeds draws, and a failure names its case
and seed."""

import re

import numpy as np
import pytest

from proptest import BASE_SEED, N_CASES, arrays, floats, given, integers, sampled_from

_OPTIONS = ["lsp0", "lsp1", "lsp2", "sp"]


def _seed(case):
    return BASE_SEED * 1_000_003 + case


def test_case_draws_match_a_hand_written_loop():
    seen = []

    @given(n=integers(-3, 40), f=floats(0.25, 4.0), v=sampled_from(_OPTIONS))
    def record(n, f, v):
        seen.append((n, f, v))

    record()
    want = []
    for case in range(N_CASES):
        rng = np.random.default_rng(_seed(case))  # strategies draw in the order written
        n = int(rng.integers(-3, 40 + 1))
        f = float(rng.uniform(0.25, 4.0))
        v = _OPTIONS[rng.integers(0, len(_OPTIONS))]
        want.append((n, f, v))
    assert seen == want
    assert len(set(seen)) > 1  # cases really differ


def test_failing_property_names_its_case_and_seed():
    case = min(3, N_CASES - 1)
    calls = []

    @given(x=integers(0, 9), a=arrays(np.float32, (3,)))
    def prop(x, a):
        calls.append(x)
        if len(calls) > case:
            raise ValueError("boom")

    rng = np.random.default_rng(_seed(case))
    x = int(rng.integers(0, 10))
    msg = f"property failed on case {case} (seed {_seed(case)}): {{'x': {x}, 'a': 'ndarray(3,):float32'}}"
    with pytest.raises(AssertionError, match=re.escape(msg)) as info:
        prop()
    assert isinstance(info.value.__cause__, ValueError)
    assert len(calls) == case + 1  # the first failing case ends the property
