"""The port's pub/sub (ray_tpu_torch.core.pubsub, experimental.pubsub)
against the reference's ray_tpu.core.pubsub.Publisher: the same sequence of
subscribes, publishes (retained or not), closes and a flood past the
bounded buffer goes through both, and what each subscriber receives is
equal. Then the runtime's own channels: actor state changes on "actors",
nothing on "nodes" (one process is one node).

Every test runs under a deadline of its own (SIGALRM) and fails on a
leftover non-daemon thread."""

import signal
import threading

import pytest

import ray_tpu_torch as rt
from ray_tpu.core import pubsub as ref_pubsub
from ray_tpu_torch.core import pubsub as port_pubsub
from ray_tpu_torch.experimental import pubsub

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        try:
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _drain(sub) -> list:
    out = []
    while True:
        msg = sub.poll(timeout=0)
        if msg is None:
            return out
        out.append(msg)


def _run_sequence(mod) -> dict:
    """One fixed script of pub/sub calls on ``mod``'s Publisher; everything
    observable about it."""
    pub = mod.Publisher()
    seen: dict = {}
    early = pub.subscribe("a")
    other = pub.subscribe("b")
    seen["delivered"] = [pub.publish("a", {"n": 1}), pub.publish("b", "x"),
                         pub.publish("c", "nobody")]
    pub.publish("a", {"n": 2, "epoch": True}, retain=True)
    late = pub.subscribe("a")  # gets the retained value at once
    pub.publish("a", {"n": 3})  # not retained: the retained value stays n 2
    later = pub.subscribe("a")
    other.close()
    seen["delivered"].append(pub.publish("b", "after close"))
    seen["early"], seen["late"], seen["later"] = _drain(early), _drain(late), _drain(later)
    seen["other"] = _drain(other)
    # flood one subscriber past its bound: the oldest go
    flood = pub.subscribe("flood")
    n = mod.BUFFER_LIMIT + 7
    for i in range(n):
        pub.publish("flood", i)
    got = _drain(flood)
    seen["flood"] = (len(got), got[0], got[-1], flood.dropped)
    seen["published_total"] = pub.published_total
    seen["empty_poll"] = early.poll(timeout=0.01)
    return seen


def test_publisher_delivers_what_the_reference_delivers():
    ref, port = _run_sequence(ref_pubsub), _run_sequence(port_pubsub)
    assert port == ref
    assert port["late"] == [{"n": 2, "epoch": True}, {"n": 3}]
    assert port["later"] == [{"n": 2, "epoch": True}]
    assert port["flood"] == (port_pubsub.BUFFER_LIMIT, 7, port_pubsub.BUFFER_LIMIT + 6, 7)


def test_experimental_surface_publishes_on_the_runtime():
    rt.init(num_cpus=2)
    sub = pubsub.subscribe("chan")
    assert pubsub.publish("chan", {"v": 1}, retain=True) == 1
    assert sub.poll(timeout=5) == {"v": 1}
    late = pubsub.subscribe("chan")
    assert late.poll(timeout=5) == {"v": 1}  # the retained value
    sub.close()
    late.close()
    assert pubsub.publish("chan", {"v": 2}) == 0


def test_actor_state_changes_on_actors_and_nothing_on_nodes():
    """Each actor's PENDING, ALIVE and DEAD go out on "actors", as the
    reference's runtime publishes them; one process publishes nothing on
    "nodes" (no node registers, dies or is preempted)."""
    rt.init(num_cpus=2)
    actors, nodes = pubsub.subscribe("actors"), pubsub.subscribe("nodes")

    @rt.remote
    class Counter:
        def ping(self):
            return "pong"

    a = Counter.options(name="counted").remote()
    assert rt.get(a.ping.remote(), timeout=10) == "pong"
    rt.kill(a)
    events = []
    while len(events) < 3:
        msg = actors.poll(timeout=5)
        assert msg is not None, events
        events.append(msg)
    assert [e["state"] for e in events] == ["PENDING", "ALIVE", "DEAD"]
    assert {e["actor_id"] for e in events} == {a._actor_id.hex()}
    assert all(e["class_name"] == "Counter" and e["name"] == "counted"
               and e["num_restarts"] == 0 for e in events)
    assert nodes.poll(timeout=0.2) is None
