"""The loops' arithmetic on a fake clock."""

import dataclasses

from phybench import loops


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def until(self, t):
        self.now = max(self.now, t)


@dataclasses.dataclass
class FakeMark:
    clock: FakeClock
    t0: float
    done_at: float

    def wait(self):
        self.clock.now = max(self.clock.now, self.done_at)

    def done_ms(self):
        return (self.done_at - self.t0) * 1e3


class FakeDevice:
    """Each submit takes ``issue`` host seconds; the device then runs the
    batch for ``service`` seconds after the one before it."""

    def __init__(self, clock, issue, service):
        self.clock, self.issue, self.service = clock, issue, service
        self.free = 0.0
        self.t0 = None

    def begin(self):
        self.t0 = self.clock.now

    def submit(self, b):
        self.clock.now += self.issue
        self.free = max(self.free, self.clock.now) + self.service
        return FakeMark(self.clock, self.t0, self.free)


def test_open_loop_times_each_batch_from_its_due_time():
    clock = FakeClock()
    dev = FakeDevice(clock, issue=0.002, service=0.025)
    r = loops.open_loop(dev.submit, dev, 4, 0.010, 2, clock=clock, until=clock.until)
    # due 10, 20, 30, 40 ms; done 37, 62, 87, 112 ms (the device is slower
    # than the period, so the third and fourth wait for a free slot).
    assert [round(x, 9) for x in r.latency_ms] == [27.0, 42.0, 57.0, 72.0]
    assert [round(x, 9) for x in r.lateness_ms] == [0.0, 0.0, 7.0, 22.0]
    assert [round(x, 9) for x in r.issue_s] == [0.002] * 4
    assert round(r.wall_s, 9) == 0.112


def test_open_loop_below_capacity_has_constant_latency():
    clock = FakeClock()
    dev = FakeDevice(clock, issue=0.003, service=0.004)
    r = loops.open_loop(dev.submit, dev, 50, 0.032, 2, clock=clock, until=clock.until)
    assert all(abs(x - 7.0) < 1e-6 for x in r.latency_ms)
    assert all(abs(x) < 1e-9 for x in r.lateness_ms)


def test_batch_window_counts_every_step_and_ends_with_a_sync():
    clock = FakeClock()
    synced = []

    def step():
        clock.now += 0.3

    def sync():
        synced.append(clock.now)
        clock.now += 0.05

    wall, issue, ends = loops.batch_window(step, 1.0, sync, clock=clock)
    assert len(issue) == 4 and all(abs(x - 0.3) < 1e-12 for x in issue)
    assert abs(wall - 1.25) < 1e-12 and len(synced) == 2
    assert [round(e, 9) for e in ends] == [0.3, 0.6, 0.9, 1.2]


def test_closed_stream_keeps_depth_in_flight():
    clock = FakeClock()
    dev = FakeDevice(clock, issue=0.001, service=0.010)
    wall = loops.closed_stream(dev.submit, dev, 10, 2, clock=clock)
    assert abs(wall - (0.001 + 10 * 0.010)) < 1e-9
