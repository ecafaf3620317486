"""gRPC ingress for serve deployments (copied from
ray_tpu/serve/grpc_ingress.py).

A second ingress protocol beside HTTP, routing to the same deployment
handles through ``serve.run``'s route table. The wire is proto-free
(generic byte handlers, JSON payloads), so no protoc step is needed:

- ``/ray_tpu.serve.Serve/Predict``: unary-unary. Request bytes = JSON
  ``{"route": "/prefix", "body": {...}}``; response bytes = JSON
  ``{"result": ...}``, what the HTTP proxy answers to the same body.
- ``/ray_tpu.serve.Serve/Stream``: unary-stream. The same request; one JSON
  frame ``{"item": ...}`` per value the deployment's streaming method
  (``body["stream_method"]``, default ``"stream_tokens"``) yields.

Errors come back as gRPC status codes: NOT_FOUND for an unknown route,
INVALID_ARGUMENT for a request that is not a JSON object, INTERNAL for a
failed replica. ``grpc`` is imported only here and only when a proxy or a
client helper is used, so ``import ray_tpu_torch.serve`` works without it.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import ray_tpu_torch

SERVICE = "ray_tpu.serve.Serve"
_TIMEOUT_S = 120.0


def _identity(b: bytes) -> bytes:
    return b


class GrpcProxy:
    """The gRPC ingress. ``port=0`` binds a free port; ``port`` reads back the
    one bound. ``stop()`` shuts the server and its thread pool down and
    waits for both."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        import grpc

        from ray_tpu_torch.serve.api import _json_safe, _match_route

        def parse(request: bytes, context):
            try:
                payload = json.loads(request)
                if not isinstance(payload, dict):
                    raise ValueError("request must be a JSON object")
                return payload.get("route", "/"), payload.get("body", {})
            except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"invalid JSON request: {e}")

        def route(request: bytes, context):
            path, body = parse(request, context)
            _, handle = _match_route(path)
            if handle is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"no route for {path!r}")
            return handle, body

        def predict(request: bytes, context) -> bytes:
            handle, body = route(request, context)
            try:
                result = ray_tpu_torch.get(handle.remote(body), timeout=_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001 - the client gets the error
                context.abort(grpc.StatusCode.INTERNAL, str(e)[:500])
            return json.dumps({"result": _json_safe(result)}).encode()

        def stream(request: bytes, context):
            handle, body = route(request, context)
            it = handle.stream(body, method_name=body.get("stream_method", "stream_tokens"))
            try:
                for item in it:
                    yield json.dumps({"item": item}).encode()
            except Exception as e:  # noqa: BLE001 - the client gets the error
                context.abort(grpc.StatusCode.INTERNAL, str(e)[:500])
            finally:
                it.close()

        handlers = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=_identity, response_serializer=_identity),
            "Stream": grpc.unary_stream_rpc_method_handler(
                stream, request_deserializer=_identity, response_serializer=_identity),
        })
        self._pool = ThreadPoolExecutor(max_workers=32, thread_name_prefix="serve-grpc")
        self._server = grpc.server(self._pool)
        self._server.add_generic_rpc_handlers((handlers,))
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            self._pool.shutdown(wait=True)
            raise RuntimeError(f"gRPC proxy failed to bind {host}:{port}")
        self.host, self.port = host, bound
        self._server.start()

    def stop(self) -> None:
        """Stop serving, cancelling calls in flight, then shut the thread
        pool down and wait for its threads. (A grace period would leave
        grpc's own non-daemon timer thread running past the return.)"""
        self._server.stop(None).wait()
        self._pool.shutdown(wait=True)


def grpc_predict(address: str, route: str, body: dict, timeout: float = _TIMEOUT_S) -> dict:
    """Client helper for the proto-free contract: one Predict call."""
    import grpc

    with grpc.insecure_channel(address) as channel:
        call = channel.unary_unary(f"/{SERVICE}/Predict", request_serializer=_identity,
                                   response_deserializer=_identity)
        out = call(json.dumps({"route": route, "body": body}).encode(), timeout=timeout)
    return json.loads(out)


def grpc_stream(address: str, route: str, body: dict, timeout: float = _TIMEOUT_S):
    """Client helper: the frames of one Stream call, as they arrive."""
    import grpc

    with grpc.insecure_channel(address) as channel:
        call = channel.unary_stream(f"/{SERVICE}/Stream", request_serializer=_identity,
                                    response_deserializer=_identity)
        for frame in call(json.dumps({"route": route, "body": body}).encode(),
                          timeout=timeout):
            yield json.loads(frame)
