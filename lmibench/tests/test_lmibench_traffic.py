"""The traffic generator and its loops, on a clock the test drives."""

import numpy as np
import pytest

from lmibench import traffic

OPEN = {"kind": "open", "size": {"dist": "geometric", "mean": 8, "min": 1,
                                 "max": 64}, "drain_s": 5, "why": "test"}
CLOSED = {"kind": "closed", "ring": 4, "why": "test"}


class Clock:
    """Reads advance it by a microsecond, as a real clock moves while it
    is read; `sleep` advances it by the time asked."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t

    def sleep(self, s):
        self.t += s


def test_every_seed_gets_the_same_sizes_and_gaps_in_another_order():
    a = traffic.open_schedule(OPEN, 100.0, 10.0, 1000, 1)
    b = traffic.open_schedule(OPEN, 100.0, 10.0, 1000, 2**33 + 5)
    assert len(a) == len(b) == 1000
    sizes = lambda s: sorted(len(r.queries) for r in s)   # noqa: E731
    assert sizes(a) == sizes(b)
    assert [len(r.queries) for r in a] != [len(r.queries) for r in b]
    for s in (a, b):
        due = np.array([r.due for r in s])
        assert due[0] == 0 and (np.diff(due) >= 0).all() and due[-1] < 10
        assert all(1 <= len(r.queries) <= 64 for r in s)
    assert traffic.open_schedule(OPEN, 100.0, 10.0, 1000, 1)[7].queries \
        .tolist() == a[7].queries.tolist()


def test_open_loop_times_from_due_under_a_stall():
    clock = Clock()
    reqs = [traffic.Request(0.1 * i, np.arange(2)) for i in range(5)]

    def serve(q):
        # the second request stalls the server for 0.35 s; others take 0.01
        clock.t += 0.35 if clock.t >= 0.1 and clock.t < 0.2 else 0.01
        return q

    served = traffic.run_open(serve, reqs, 0.5, 5.0, clock=clock,
                              sleep=clock.sleep)
    lat = served.end - np.array([r.due for r in reqs])
    # requests due behind the stall wait for it: latency from due time
    assert np.allclose(lat, [0.01, 0.35, 0.26, 0.17, 0.08], atol=1e-4)
    assert np.allclose(served.start, [0.0, 0.1, 0.45, 0.46, 0.47], atol=1e-4)


def test_open_loop_gives_up_after_the_drain():
    clock = Clock()
    reqs = [traffic.Request(0.0, np.arange(1)) for _ in range(3)]

    def serve(q):
        clock.t += 10.0
        return q

    served = traffic.run_open(serve, reqs, 1.0, 5.0, clock=clock,
                              sleep=clock.sleep)
    assert np.isnan(served.end[-2:]).all() and served.results[-1] is None


def test_closed_loop_sends_ring_orders_until_the_window_ends():
    clock = Clock()
    ring = traffic.closed_ring({"ring": 3}, 10, 7)
    assert all(sorted(r) == list(range(10)) for r in ring)
    assert ring[0].tolist() != ring[1].tolist()
    seen = []

    def serve(slot):
        seen.append(slot)
        clock.t += 0.3
        return slot

    served = traffic.run_closed(serve, ring, 1.0, clock=clock)
    assert seen == [0, 1, 2, 0]
    assert abs(served.window_s - 1.2) < 1e-4
    assert served.requests[3].queries is ring[0]


@pytest.mark.parametrize("bad", [
    {**CLOSED, "clients": 4},
    {**OPEN, "arrivals": "bursty"},
    {**OPEN, "size": {**OPEN["size"], "dist": "uniform"}},
    {**OPEN, "size": {**OPEN["size"], "p": 0.5}},
    {"kind": "stream", "why": "test"},
    {k: v for k, v in CLOSED.items() if k != "ring"},
])
def test_a_mix_with_a_setting_the_loops_do_not_read_is_refused(bad):
    with pytest.raises(ValueError):
        traffic.check_mix(bad)
    assert traffic.check_mix(CLOSED) is CLOSED
    assert traffic.check_mix(OPEN) is OPEN
