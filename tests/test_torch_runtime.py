"""The port's in-process runtime (ray_tpu_torch.core): objects, tasks, thread
actors, streaming, kill and shutdown, with the semantics of ray_tpu.core's
thread path.

Every test runs under a deadline of its own (SIGALRM, so a hang fails that
test instead of holding a worker), and its teardown shuts the runtime down
and checks that it left no non-daemon thread behind."""

import signal
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, RayTpuError, TaskError

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


@pytest.fixture
def runtime():
    rt.init(num_cpus=4, num_gpus=0)


@rt.remote
def double(x):
    return 2 * x


@rt.remote
def fail(msg):
    raise ValueError(msg)


@rt.remote
def sleepy(s):
    time.sleep(s)
    return s


def test_put_get_and_ref_args(runtime):
    ref = rt.put({"a": 1})
    assert rt.get(ref, timeout=5) == {"a": 1}
    assert rt.get([double.remote(i) for i in range(6)], timeout=10) == [0, 2, 4, 6, 8, 10]
    assert rt.get(double.remote(double.remote(rt.put(3))), timeout=10) == 12


def test_get_times_out(runtime):
    ref = sleepy.remote(2.0)
    t0 = time.monotonic()
    with pytest.raises(GetTimeoutError):
        rt.get(ref, timeout=0.1)
    assert time.monotonic() - t0 < 1.0
    assert rt.get(ref, timeout=10) == 2.0


def test_wait_returns_what_is_ready_by_its_timeout(runtime):
    fast, slow = double.remote(1), sleepy.remote(3.0)
    ready, not_ready = rt.wait([slow, fast], num_returns=1, timeout=10)
    assert ready == [fast] and not_ready == [slow]
    ready, not_ready = rt.wait([slow, fast], num_returns=2, timeout=0.2)
    assert ready == [fast] and not_ready == [slow]
    with pytest.raises(ValueError):
        rt.wait([fast], num_returns=2)


def test_task_error_is_reraised_with_its_cause(runtime):
    with pytest.raises(TaskError, match="kaboom") as info:
        rt.get(fail.remote("kaboom"), timeout=10)
    assert isinstance(info.value.cause, ValueError)
    assert "kaboom" in info.value.remote_tb


def test_tasks_wait_for_resources(runtime):
    @rt.remote(num_cpus=4)
    def whole():
        start = time.monotonic()
        time.sleep(0.1)
        return start, time.monotonic()

    (s1, e1), (s2, e2) = sorted(rt.get([whole.remote(), whole.remote()], timeout=10))
    assert e1 <= s2  # each takes every CPU, so they ran one after the other
    assert rt.available_resources()["CPU"] == 4.0
    assert rt.cluster_resources() == {"CPU": 4.0}
    with pytest.raises(ValueError, match="infeasible"):
        whole.options(num_cpus=5).remote()
    with pytest.raises(ValueError, match="infeasible"):
        whole.options(num_cpus=1, num_gpus=1).remote()


def test_gpu_resource_counts_the_cuda_devices(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    rt.init(num_cpus=2)
    assert rt.cluster_resources() == {"CPU": 2.0, "GPU": 2.0}
    with pytest.raises(RuntimeError, match="called twice"):
        rt.init()
    rt.init(ignore_reinit_error=True)
    assert rt.is_initialized()


@pytest.mark.parametrize("max_concurrency", [1, 4])
def test_actor_runs_up_to_max_concurrency_calls_at_once(runtime, max_concurrency):
    @rt.remote(max_concurrency=max_concurrency, num_cpus=0)
    class Counter:
        def __init__(self):
            self.lock = threading.Lock()
            self.now = self.peak = 0

        def work(self):
            with self.lock:
                self.now += 1
                self.peak = max(self.peak, self.now)
            time.sleep(0.1)
            with self.lock:
                self.now -= 1

        def get_peak(self):
            return self.peak

    c = Counter.remote()
    rt.get([c.work.remote() for _ in range(8)], timeout=20)
    assert rt.get(c.get_peak.remote(), timeout=5) == max_concurrency


def test_actor_keeps_state_and_reraises_method_errors(runtime):
    @rt.remote
    class Acc:
        def __init__(self, start):
            self.total = start

        def add(self, x):
            self.total += x
            return self.total

        def bad(self):
            raise KeyError("missing")

    a = Acc.remote(10)
    assert rt.get([a.add.remote(i) for i in range(4)], timeout=10) == [10, 11, 13, 16]
    with pytest.raises(TaskError) as info:
        rt.get(a.bad.remote(), timeout=10)
    assert isinstance(info.value.cause, KeyError)
    with pytest.raises(AttributeError):
        a.nope


def test_named_actor_and_get_if_exists(runtime):
    @rt.remote
    class Box:
        def __init__(self, v):
            self.v = v

        def value(self):
            return self.v

    first = Box.options(name="box").remote(1)
    again = Box.options(name="box", get_if_exists=True).remote(2)
    assert again == first
    assert rt.get(rt.get_actor("box").value.remote(), timeout=10) == 1
    with pytest.raises(ValueError, match="already exists"):
        Box.options(name="box").remote(3)
    with pytest.raises(ValueError, match="Failed to look up"):
        rt.get_actor("nobody")
    rt.kill(first)
    with pytest.raises(ValueError):
        rt.get_actor("box")  # a killed actor's name is free again
    assert rt.get(Box.options(name="box").remote(4).value.remote(), timeout=10) == 4


def test_kill_fails_pending_and_new_calls(runtime):
    gate = threading.Event()

    @rt.remote(num_cpus=0)
    class Blocker:
        def hold(self):
            gate.wait(20)
            return "done"

        def ping(self):
            return "pong"

    b = Blocker.remote()
    running = b.hold.remote()
    time.sleep(0.2)  # let the one thread take the first call
    pending = [b.ping.remote() for _ in range(3)]
    rt.kill(b)
    for ref in pending:
        with pytest.raises(ActorDiedError):
            rt.get(ref, timeout=10)
    with pytest.raises(ActorDiedError):
        rt.get(b.ping.remote(), timeout=10)
    gate.set()
    assert rt.get(running, timeout=10) == "done"  # a running call finishes


def test_constructor_error_kills_the_actor(runtime):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("no CUDA device here")

        def ping(self):
            return 1

    b = Broken.remote()
    with pytest.raises(ActorDiedError, match="no CUDA device here"):
        rt.get(b.ping.remote(), timeout=10)
    with pytest.raises(TaskError, match="no CUDA device here"):
        rt.get(rt.core.runtime.get_runtime().actor_ready(b._actor_id), timeout=10)


@pytest.mark.parametrize("where", ["task", "actor"])
def test_streaming_generator_yields_in_order(runtime, where):
    def gen(n):
        for i in range(n):
            time.sleep(0.01)
            yield i * 11
        raise ValueError("after the last item")

    if where == "task":
        stream = rt.remote(num_returns="streaming")(gen).remote(4)
    else:
        @rt.remote
        class G:
            def items(self, n):
                yield from gen(n)

        stream = G.remote().items.options(num_returns="streaming").remote(4)
    refs = iter(stream)
    assert [rt.get(next(refs), timeout=10) for _ in range(4)] == [0, 11, 22, 33]
    with pytest.raises(TaskError, match="after the last item"):
        rt.get(next(refs), timeout=10)
    with pytest.raises(StopIteration):
        next(refs)
    assert stream.completed()


@pytest.mark.parametrize("where", ["task", "actor method"])
def test_num_returns_is_one_or_streaming(runtime, where):
    @rt.remote
    class A:
        def pair(self):
            return 1, 2

    with pytest.raises(ValueError, match="num_returns must be 1 or 'streaming'"):
        if where == "task":
            rt.remote(num_returns=2)(lambda: (1, 2))
        else:
            A.remote().pair.options(num_returns=2)
    with pytest.raises(ValueError, match="unknown .* option"):
        rt.remote(resources={"accelerator_slot": 1})(lambda: 1)


def test_shutdown_fails_pending_refs_within_its_deadline(runtime):
    @rt.remote(num_cpus=0)
    class Slow:
        def hang(self):
            time.sleep(10)

    s = Slow.remote()
    first = s.hang.remote()
    queued = s.hang.remote()
    task = sleepy.remote(10)
    time.sleep(0.2)
    t0 = time.monotonic()
    rt.core.runtime.get_runtime().shutdown(timeout=1.0)
    assert time.monotonic() - t0 < 3.0
    assert not rt.is_initialized()
    for ref in (first, queued, task):
        with pytest.raises(RayTpuError):
            ref._runtime.get([ref], timeout=5)


def test_concurrent_submitters_lose_no_call_and_leave_no_object(runtime):
    """More submitting threads than cores, with a short switch interval: every
    call runs once, the actor's thread claims stay within max_concurrency,
    and once the refs are gone the store holds nothing."""
    import sys

    @rt.remote(max_concurrency=8, num_cpus=0)
    class Tally:
        def __init__(self):
            self.lock = threading.Lock()
            self.n = 0

        def add(self, k):
            with self.lock:
                self.n += k
            return k

        def total(self):
            return self.n

    tally = Tally.remote()
    errors = []

    def submit(i):
        try:
            refs = [tally.add.remote(1) for _ in range(50)] + [double.remote(i)]
            assert rt.get(refs, timeout=30)[-1] == 2 * i
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert rt.get(tally.total.remote(), timeout=10) == 16 * 50
    store = rt.core.runtime.get_runtime()
    actor = store._actors[tally._actor_id]
    assert len(actor.threads) <= 8
    assert len(store._objects) == 1  # the actor's ready marker, which its runtime holds
