"""The port's gRPC ingress (ray_tpu_torch.serve.grpc_ingress) on the CPU:
tests/test_serve_hardening.py:165 mirrored (unary Predict, server-streaming
Stream and NOT_FOUND over the same route table as HTTP), plus INTERNAL for
a failed replica and INVALID_ARGUMENT for a request that is not a JSON
object, and Predict's JSON against the HTTP proxy's answer to the same
body. The card machine has no ``grpc``, so this file runs here only.

Every test runs under a deadline of its own (SIGALRM), binds port 0 and
fails on a leftover non-daemon thread: stopping the proxy stops its server
and its thread pool."""

import json
import signal
import threading
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

grpc = pytest.importorskip("grpc")
from ray_tpu_torch.serve.grpc_ingress import grpc_predict, grpc_stream  # noqa: E402

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        rt.init(num_cpus=8, num_gpus=0)
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


@serve.deployment(num_replicas=1)
class EchoPlus:
    def __call__(self, body):
        if body.get("fail"):
            raise RuntimeError("replica failed on purpose")
        return {"sum": sum(body.get("xs", []))}

    def counters(self, body):
        yield from range(int(body.get("n", 3)))


def _address(proxy) -> str:
    assert proxy.port > 0  # port 0 bound a free port and reports it
    return f"{proxy.host}:{proxy.port}"


def test_grpc_ingress_predict_stream_and_not_found():
    serve.run(EchoPlus.bind(), route_prefix="/gx")
    addr = _address(serve.start_grpc_proxy(port=0))
    assert grpc_predict(addr, "/gx", {"xs": [1, 2, 3]}) == {"result": {"sum": 6}}
    frames = list(grpc_stream(addr, "/gx", {"n": 4, "stream_method": "counters"}))
    assert [f["item"] for f in frames] == [0, 1, 2, 3]
    with pytest.raises(grpc.RpcError) as err:
        grpc_predict(addr, "/nope", {})
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        list(grpc_stream(addr, "/nope", {}))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_ingress_internal_and_invalid_argument():
    serve.run(EchoPlus.bind(), route_prefix="/gx")
    addr = _address(serve.start_grpc_proxy(port=0))
    with pytest.raises(grpc.RpcError) as err:
        grpc_predict(addr, "/gx", {"fail": True})
    assert err.value.code() == grpc.StatusCode.INTERNAL
    assert "ReplicaActor.handle_request failed" in err.value.details()
    with grpc.insecure_channel(addr) as channel:
        call = channel.unary_unary("/ray_tpu.serve.Serve/Predict",
                                   request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as err:
            call(b"[1, 2]", timeout=30)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    # the replica is still serving
    assert grpc_predict(addr, "/gx", {"xs": [4]}) == {"result": {"sum": 4}}


def test_grpc_predict_answers_what_http_answers():
    serve.run(EchoPlus.bind(), route_prefix="/gx")
    addr = _address(serve.start_grpc_proxy(port=0))
    http_port = serve.start_http_proxy(port=0).port
    body = {"xs": [2.5, 7, -1]}
    req = urllib.request.Request(f"http://127.0.0.1:{http_port}/gx",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        http_answer = json.loads(r.read())
    assert grpc_predict(addr, "/gx", body) == http_answer == {"result": {"sum": 8.5}}


def test_stopped_grpc_proxy_leaves_no_thread_and_a_new_one_starts():
    serve.run(EchoPlus.bind(), route_prefix="/gx")
    first = serve.start_grpc_proxy(port=0)
    assert serve.start_grpc_proxy(port=0) is first  # once per serve session
    assert grpc_predict(_address(first), "/gx", {"xs": [1]}) == {"result": {"sum": 1}}
    serve.shutdown()  # stops the proxy: server and pool joined
    assert not [t for t in threading.enumerate() if t.name.startswith("serve-grpc")]
    serve.run(EchoPlus.bind(), route_prefix="/gx")
    second = serve.start_grpc_proxy(port=0)
    assert second is not first
    assert grpc_predict(_address(second), "/gx", {"xs": [5, 5]}) == {"result": {"sum": 10}}
