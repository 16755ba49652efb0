"""The port's ``RangeMap`` held to ``tests/test_range_map.py``.

The reference suite runs here with the port in place
(``torch_reference.suite_on_port``), its property case against the
dict-of-points model included.  Beyond it, the same hypothesis-drawn
sequence of mutations (values, deletions, gap callbacks that keep or
replace what they see) must leave the port's map in the JAX package's
state, with the same callbacks seen on the way.
"""
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from mysticeti_tpu.range_map import RangeMap as JaxRangeMap  # noqa: E402
from mysticeti_tpu_torch.range_map import RangeMap as PortRangeMap  # noqa: E402
from torch_reference import suite_on_port  # noqa: E402

globals().update(suite_on_port("test_range_map.py"))

# (start, end, what the callback does): set a value, delete, keep what it
# sees, or fold the old value into a new one.
MUTATION = st.tuples(st.integers(0, 40), st.integers(0, 40),
                     st.one_of(st.integers(0, 3), st.sampled_from(("delete", "keep", "fold"))))


def replay(cls, mutations):
    rm = cls()
    seen = []
    for start, end, what in mutations:
        def callback(s, e, old, what=what):
            seen.append((s, e, old))
            if what == "delete":
                return None
            if what == "keep":
                return old
            if what == "fold":
                return (old or 0) * 2 + 1
            return what

        rm.mutate_range(start, end, callback)
        seen.append(("items", list(rm.items()), len(rm), rm.is_empty()))
    return seen, [rm.get(k) for k in range(42)]


@settings(max_examples=200, deadline=None)
@given(st.lists(MUTATION, max_size=16))
def test_mutations_as_the_jax_package(mutations):
    assert replay(PortRangeMap, mutations) == replay(JaxRangeMap, mutations)
