"""The traffic generator: every traffic file makes the same amount of work
for every seed, its kinds of path and step are found by name, and the
steps drive a system as the file says (set-up once, the window cycled
with every path's cursor back at its start)."""

import json
from pathlib import Path

import numpy as np
import pytest

from slambench import harness, traffic_plan

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
SEEDS = (7, 2**31 + 99)


@pytest.mark.parametrize("name", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_same_work_for_every_seed(name):
    spec = json.loads((TRAFFIC / f"{name}.json").read_text())
    a, b = (traffic_plan.make_plan(spec, s) for s in SEEDS)
    assert a.length == b.length and a.setup == b.setup and a.window == b.window
    assert not np.allclose(np.stack(a.poses), np.stack(b.poses))
    again = traffic_plan.make_plan(spec, SEEDS[0])
    assert np.array_equal(np.stack(a.poses), np.stack(again.poses))


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        traffic_plan.make_plan({"paths": {"p": {"kind": "no_such_kind"}}, "window": []}, 1)


class FakeTracker:
    NOT_INITIALIZED = "NOT_INITIALIZED"

    def __init__(self, init_after):
        self.state, self.init_after, self.n = self.NOT_INITIALIZED, init_after, 0
        self.flushed = 0

    def flush(self):
        self.flushed += 1


class FakeSystem:
    def __init__(self, init_after=3):
        self.tracker = FakeTracker(init_after)
        self.log = []

    def reset(self):
        self.log.append("reset")
        self.tracker.state, self.tracker.n = self.tracker.NOT_INITIALIZED, 0

    def activate_localization_mode(self):
        self.log.append("localize")


class FakeFeeder:
    def __init__(self, plan, system):
        self.plan, self.system = plan, system
        self.cursor = {n: 0 for n in plan.length}

    def initialized(self):
        return self.system.tracker.state != FakeTracker.NOT_INITIALIZED

    def track(self, idx):
        t = self.system.tracker
        t.n += 1
        if t.n >= t.init_after:
            t.state = "OK"
        self.system.log.append(idx)

    def call(self, method):
        obj = self.system
        for part in method.split("."):
            obj = getattr(obj, part)
        obj()


def _drive(name, n_window):
    spec = json.loads((TRAFFIC / f"{name}.json").read_text())
    plan = traffic_plan.make_plan(spec, SEEDS[0])
    sys_ = FakeSystem()
    d = FakeFeeder(plan, sys_)
    for _ in harness.drive(d, plan.setup, cycle=False):
        pass
    n_setup = len(sys_.log)
    w = harness.drive(d, plan.window, cycle=True)
    for _ in range(n_window):
        next(w)
    return plan, sys_, n_setup


def test_orbit_initializes_in_setup_then_runs_on_and_cycles():
    plan, sys_, n_setup = _drive("orbit", 2 * 120 + 10)
    o0, o1 = plan.offset["arc0"], plan.offset["arc1"]
    # set-up: until initialized (3 frames here), then 4 more
    assert sys_.log[:n_setup] == list(range(o0, o0 + 7))
    win = sys_.log[n_setup:]
    assert win[:113] == list(range(o0 + 7, o0 + 120))
    assert win[113] == "reset"
    assert win[114:234] == list(range(o1, o1 + 120))
    assert win[234] == "reset"
    assert win[235:] == list(range(o0, o0 + len(win) - 235))   # arc0 from its start


def test_localize_maps_then_sweeps():
    plan, sys_, n_setup = _drive("localize", 3 * plan_len("localize"))
    m, s = plan.offset["map"], plan.offset["sweep"]
    assert sys_.log[:30] == list(range(m, m + 30))
    assert sys_.tracker.flushed == 1 and sys_.log[30] == "localize"
    assert sys_.log[31:37] == list(range(s, s + 6))
    n = plan.length["sweep"]
    win = sys_.log[n_setup:]
    assert win[:n - 6] == list(range(s + 6, s + n))
    assert win[n - 6:2 * n - 6] == list(range(s, s + n))


def plan_len(name):
    spec = json.loads((TRAFFIC / f"{name}.json").read_text())
    return traffic_plan.make_plan(spec, 1).length["sweep"]
