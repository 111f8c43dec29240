"""PyTorch port, speculative decoding through ``ServeEngine(spec=...)`` on
the CPU, the identity self-draft: w4a8's ``self4`` (every proposal
accepted, no truncate) on slot, paged and prefix, greedy and seeded
(temperature 0.8, top-k 8, top-p 0.9, seed 17 + i), against the JAX
reference's spec engine (tests/test_spec.py) and the port's own
non-speculative engine. Drafts that get rejected are
tests/test_torch_spec_rollback.py; the set-up, tests/_torch_spec_common.py.

Every offset of a verify draws at the counter the serialized engine uses
for that emission, so the streams are the serialized ones whatever the
draft proposes. Tolerance: none: streams, ``spec/`` metrics and
``cache/truncates`` equal the reference's.
"""

import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import one_torch_thread  # noqa: E402, F401

from tests._torch_spec_common import (  # noqa: E402, F401
    CACHES,
    check_selfdraft,
    params,
)


@pytest.mark.parametrize("cache", CACHES)
def test_selfdraft_equals_reference_and_serialized(params, cache):  # noqa: F811
    check_selfdraft(params, cache, 0.0)


@pytest.mark.parametrize("cache", CACHES)
def test_sampled_selfdraft_equals_reference_and_serialized(params, cache):  # noqa: F811
    check_selfdraft(params, cache, 0.8)
