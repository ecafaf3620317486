"""``@serve.batch`` and ``@serve.multiplexed`` in the port
(ray_tpu_torch.serve.batching / multiplex) against the reference modules on
the same calls, and the assertions of tests/test_serve.py (batching) and
tests/test_tracing_multiplex.py (multiplexing) over the port's serve; plus
the port's thread rules: ``serve.shutdown()`` fails a batch's queued
callers and ends a wait for another request's model load.

Every test runs under a deadline of its own (SIGALRM) and fails on a
leftover non-daemon thread."""

import signal
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu.serve import batching as ref_batching
from ray_tpu.serve import multiplex as ref_multiplex
from ray_tpu_torch import serve
from ray_tpu_torch.serve import batching, multiplex

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
            serve.shutdown()
            rt.shutdown()
            time.sleep(0.05)  # a cancelled flush timer's thread ends
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _concurrent(fn, items):
    results = [None] * len(items)
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, fn(items[i])))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    return results


# ---------------------------------------------------------- both modules
@pytest.mark.parametrize("max_batch, n", [(1, 3), (4, 8), (4, 10), (16, 5)])
def test_batches_as_the_reference_does(max_batch, n):
    """The same calls at once: each caller gets its own element and no
    batch exceeds max_batch_size."""
    out = {}
    for name, mod in (("port", batching), ("reference", ref_batching)):
        sizes = []

        @mod.batch(max_batch_size=max_batch, batch_wait_timeout_s=0.05)
        def process(items):
            sizes.append(len(items))
            return [i * 10 for i in items]

        out[name] = (_concurrent(process, list(range(n))), sum(sizes),
                     max(sizes) <= max_batch)
    assert out["port"] == out["reference"] == ([i * 10 for i in range(n)], n, True)


@pytest.mark.parametrize("name", ["port", "reference"])
def test_wrong_result_count_fails_every_caller(name):
    mod = batching if name == "port" else ref_batching

    @mod.batch(max_batch_size=2, batch_wait_timeout_s=0.5)
    def short(items):
        return items[:1]

    errors = []

    def call(i):
        try:
            short(i)
        except ValueError as e:
            errors.append(str(e))

    _concurrent(call, [1, 2])
    assert len(errors) == 2 and all("returned 1 results for 2" in e for e in errors)


def test_multiplexed_lru_matches_the_reference():
    """The same load/evict sequence gives the same loads, unloads and
    current model id in both modules."""
    seq = ["a", "b", "a", "c", "b", "b", "d", "a"]
    out = {}
    for name, mod in (("port", multiplex), ("reference", ref_multiplex)):
        loads, unloads = [], []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def unload(self):
                unloads.append(self.mid)

        class Host:
            @mod.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                loads.append(model_id)
                return Model(model_id)

        host = Host()
        got = [(host.get_model(m).mid, mod.get_multiplexed_model_id()) for m in seq]
        out[name] = (got, loads, unloads)
    assert out["port"] == out["reference"]
    assert out["port"][1] == ["a", "b", "c", "b", "d", "a"]


# ------------------------------------------------ over the port's serve
def test_batching_inside_a_deployment_method():
    rt.init(num_cpus=8, num_gpus=0)
    sizes = []

    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def handle(self, items):
            sizes.append(len(items))
            return [x + 100 for x in items]

        def __call__(self, body):
            return self.handle(body["x"])

    h = serve.run(Batched.bind())
    refs = [h.remote({"x": i}) for i in range(8)]
    assert rt.get(refs, timeout=20) == [100 + i for i in range(8)]
    assert max(sizes) > 1 and max(sizes) <= 4


def test_shutdown_fails_a_pending_batch_and_stops_its_flush():
    batcher = batching._Batcher(lambda items: items, max_batch_size=100,
                                batch_wait_timeout_s=30.0)
    errors = []

    def call():
        try:
            batcher.submit(1)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=call, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while batcher._flusher is None and time.monotonic() < deadline:
        time.sleep(0.01)
    timer = batcher._flusher
    assert timer is not None
    serve.shutdown()  # with no serve running, it still stops every batcher
    t.join(timeout=5)
    timer.join(timeout=5)
    assert not t.is_alive() and errors and "shut down" in errors[0]
    assert not timer.is_alive() and batcher._flusher is None
    assert batcher.submit.__self__ is batcher and batcher._queue == []


def test_multiplexed_lru_over_serve():
    rt.init(num_cpus=8, num_gpus=0)
    loads, unloads = [], []

    class FakeModel:
        def __init__(self, mid):
            self.mid = mid

        def unload(self):
            unloads.append(self.mid)

    @serve.deployment
    class MuxHost:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            loads.append(model_id)
            return FakeModel(model_id)

        def __call__(self, body):
            model = self.get_model(body["model"])
            return {"model": model.mid, "active": serve.get_multiplexed_model_id()}

    h = serve.run(MuxHost.bind())
    assert rt.get(h.remote({"model": "a"}), timeout=10)["model"] == "a"
    assert rt.get(h.remote({"model": "b"}), timeout=10)["active"] == "b"
    assert rt.get(h.remote({"model": "a"}), timeout=10)["model"] == "a"
    assert loads == ["a", "b"]
    rt.get(h.remote({"model": "c"}), timeout=10)
    assert unloads == ["b"]
    rt.get(h.remote({"model": "b"}), timeout=10)
    assert loads == ["a", "b", "c", "b"]


def test_multiplexed_async_loader_and_model_id_reset():
    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment
    class AsyncMux:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            import asyncio

            await asyncio.sleep(0.01)
            return {"id": model_id}

        async def __call__(self, body):
            if body.get("load"):
                return self.get_model(body["m"])["id"]
            return serve.get_multiplexed_model_id()

    h = serve.run(AsyncMux.bind())
    assert rt.get(h.remote({"m": "z", "load": True}), timeout=15) == "z"
    assert rt.get(h.remote({}), timeout=10) == ""  # no stale id across requests


def test_multiplexed_concurrent_requests_load_once():
    rt.init(num_cpus=8, num_gpus=0)
    loads = []

    @serve.deployment(max_ongoing_requests=8)
    class Mux2:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            loads.append(model_id)
            time.sleep(0.6)  # longer than one wait slice
            return model_id

        def __call__(self, body):
            return self.get_model(body["m"])

    h = serve.run(Mux2.bind())
    refs = [h.remote({"m": "same"}) for _ in range(4)]
    assert rt.get(refs, timeout=20) == ["same"] * 4
    assert loads == ["same"]


def test_shutdown_ends_a_wait_for_another_requests_load():
    release = threading.Event()

    class Host:
        @multiplex.multiplexed(max_num_models_per_replica=1)
        def get_model(self, model_id):
            release.wait(10)
            return model_id

    host = Host()
    loader = threading.Thread(target=host.get_model, args=("m",), daemon=True)
    loader.start()
    time.sleep(0.1)
    errors = []

    def waiter():
        try:
            host.get_model("m")
        except RuntimeError as e:
            errors.append(str(e))

    w = threading.Thread(target=waiter, daemon=True)
    w.start()
    time.sleep(0.1)
    multiplex.shutdown()
    w.join(timeout=5)
    release.set()
    loader.join(timeout=5)
    assert not w.is_alive() and errors and "shut down" in errors[0]
    assert host.get_model("m") == "m"  # the finished load is cached
