"""The root conftest's xdist scheduler: under `--dist loadfile` the tests named in
its HEAVY are work units of their own at the head of the queue, longest first,
and every other test keeps its file's unit and xdist's order."""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
from xdist.remote import Producer

_ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("root_conftest", _ROOT / "conftest.py")
order = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(order)


class _Node:
    def __init__(self, name, sent):
        self.gateway = SimpleNamespace(id=name)
        self.sent = sent  # (node, collection index), in the order handed out
        self.shutting_down = False

    def send_runtest_some(self, indexes):
        self.sent.extend((self, i) for i in indexes)

    def shutdown(self):
        self.shutting_down = True


def _config(dist, n_nodes):
    opts = {"dist": dist, "tx": [f"{n_nodes}*popen"]}
    return SimpleNamespace(getvalue=opts.__getitem__, option=SimpleNamespace(loadscopereorder=True))


def test_heavy_tests_run_first_longest_first_as_their_own_units():
    heavy = list(order.HEAVY[:4])
    light_parity = "tests/test_sharded_parity.py::test_light"
    many = [f"tests/test_many.py::test_{i}" for i in range(5)]
    # collection order puts the heavy tests last and in reverse
    collection = many + [light_parity] + heavy[::-1]
    sent = []
    nodes = [_Node("gw0", sent), _Node("gw1", sent)]
    sched = order.pytest_xdist_make_scheduler(_config("loadfile", 2), Producer("t", enabled=False))
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    done = 0
    while done < len(sent):  # each node runs what it was sent, in turn
        node, index = sent[done]
        sched.mark_test_complete(node, index)
        done += 1
    ran = [collection[i] for _, i in sent]
    assert ran == heavy + many + [light_parity]
    # the first two heavy tests start at once, one on each node
    assert [node for node, _ in sent[:2]] == nodes
    assert sched.tests_finished


def test_other_dist_modes_keep_xdist_schedulers():
    assert order.pytest_xdist_make_scheduler(_config("load", 2), Producer("t", enabled=False)) is None


@pytest.mark.parametrize("nodeid", order.HEAVY)
def test_each_heavy_test_exists(nodeid):
    path, name = nodeid.split("::")
    assert re.search(rf"^def {name}\(", (_ROOT / path).read_text(), re.M)
