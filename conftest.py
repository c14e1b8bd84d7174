"""Orders the work of ``pytest -n N --dist loadfile`` (pytest-xdist).

xdist hands out whole files, queued by how many tests each collects, most
first. A ``tests/proptest.py::given`` property is one test that loops over all
its drawn cases, so the files of heavy properties collect few tests: they would
start last and then run alone while the other workers sit idle. Here each test
in ``HEAVY`` is a work unit of its own, and the queue starts with them, longest
first. Every other test stays in its file's unit, in xdist's order.
"""

import pytest

# The longest tests, longest first by their time in a whole ``-n 6`` run. A
# name that is renamed or gone only loses its place; tests/test_xdist_order.py
# checks that each still exists.
HEAVY = (
    "tests/test_sharded_parity.py::test_competitive_block_budget_bit_identical",
    "tests/test_sharded_parity.py::test_sharded_pruning_invariants",
    "tests/test_sharded_parity.py::test_sharded_retrieve_bit_identical",
    "tests/test_api.py::test_dynamic_sweep_bit_identical_and_zero_recompiles",
    "tests/test_sharded_parity.py::test_ragged_tail_shards",
    "tests/test_sharded_parity.py::test_competitive_budget_ties_at_merge_boundary",
    "tests/test_sharded_parity.py::test_equal_score_ties_at_merge_boundary",
    "tests/test_api.py::test_mixed_batch_rows_match_per_point_programs",
    "tests/test_sharded_parity.py::test_engine_parity_single_vs_sharded",
    "tests/test_sharded_parity.py::test_sharded_retriever_callable_and_warmup",
)


def unit_of(nodeid):
    """The work unit of a test: the test itself if it is in HEAVY, else its file."""
    test = nodeid.split("[", 1)[0]
    return test if test in HEAVY else nodeid.split("::", 1)[0]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeavyFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit_of(nodeid)

        def _assign_work_unit(self, node):
            for unit in reversed(HEAVY):
                if unit in self.workqueue:
                    self.workqueue.move_to_end(unit, last=False)
            super()._assign_work_unit(node)

    return HeavyFirstScheduling(config, log)
