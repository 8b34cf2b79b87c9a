"""Whole-pass window accounting on a fake clock."""

from bench_port import window


class FakeSession:
    def __init__(self, clock, costs, inst):
        self.buckets = [{"name": f"b{i}"} for i in range(len(costs))]
        self.clock, self.costs, self.inst = clock, costs, inst
        self.log = []

    def work(self, bi):
        return {"kind": "k", "inst": self.inst[bi], "steps": 10,
                "bound_s": 0.0, "mxu_flop": 0.0}

    def call(self, bi, seed):
        self.clock.t += self.costs[bi]
        self.log.append(("call", bi, seed))
        return (bi, seed)

    def read(self, handle):
        self.log.append(("read", handle[0], handle[1]))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_ends_at_the_first_pass_boundary_past_seconds():
    clock = Clock()
    s = FakeSession(clock, [1.0, 2.0, 0.5], [4, 5, 6])
    res = window.run_window(s, window.Seeds(7), seconds=6.0, clock=clock)
    # a pass takes 3.5 s: 3.5 < 6, 7.0 >= 6 -> two whole passes
    assert res["passes"] == 2 and len(res["calls"]) == 6
    assert res["window_s"] == 7.0
    assert res["inst_steps"] == 2 * 10 * (4 + 5 + 6)
    assert [c["bucket"] for c in res["calls"]] == ["b0", "b1", "b2"] * 2


def test_results_are_read_after_the_next_enqueue():
    clock = Clock()
    s = FakeSession(clock, [1.0, 1.0], [1, 1])
    window.run_window(s, window.Seeds(7), seconds=0.5, clock=clock)
    kinds = [(k, b) for k, b, _ in s.log]
    assert kinds == [("call", 0), ("call", 1), ("read", 0), ("read", 1)]


def test_call_seeds_follow_the_call_index_and_repeat_with_the_seed():
    seeds = window.Seeds(2 ** 31 + 5)
    a = [seeds.call(i) for i in range(4)]
    assert len(set(a)) == 4 and all(0 <= x < 2 ** 31 for x in a)
    assert a == [window.Seeds(2 ** 31 + 5).call(i) for i in range(4)]
    clock = Clock()
    s = FakeSession(clock, [1.0, 1.0], [1, 1])
    window.run_window(s, seeds, seconds=2.0, clock=clock)
    assert [seed for k, _, seed in s.log if k == "call"] == \
        [seeds.call(i) for i in range(2)]


def test_a_failed_call_counts_and_adds_no_work():
    clock = Clock()
    s = FakeSession(clock, [1.0, 1.0], [3, 3])
    real = s.call

    def flaky(bi, seed):
        if bi == 1:
            raise RuntimeError("launch failed")
        return real(bi, seed)

    s.call = flaky
    res = window.run_window(s, window.Seeds(1), seconds=0.5, clock=clock)
    assert res["failed"] == 1 and res["inst_steps"] == 30
